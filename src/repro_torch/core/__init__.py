"""The paper's runtime allocator in PyTorch (counterpart of ``repro.core``).

The entry point is :class:`CapacityEngine` with :class:`SolverConfig` /
:class:`Policies`; the mechanism lives in ``game`` (Algorithm 4.1),
``rounding`` (Algorithm 4.2) and ``centralized`` (the exact P3 optimum).
"""
from repro_torch.core.centralized import (kkt_residual, objective_of_r,
                                          solve_centralized,
                                          solve_centralized_batch)
from repro_torch.core.engine import (BatchSolveReport, CapacityEngine,
                                     CrossCheckPolicy, InfeasibleError,
                                     Policies, RoundingPolicy, SolveReport,
                                     SolverConfig, WindowSession)
from repro_torch.core.game import (BatchWarmStart, cm_best_response,
                                   cm_bid_update, cold_start, rm_solve,
                                   solve_distributed, solve_distributed_batch,
                                   solve_distributed_python)
from repro_torch.core.profiles import sample_class_params, sample_scenario
from repro_torch.core.rounding import (IntegerSolution, round_solution,
                                       round_solution_batch)
from repro_torch.core.types import (RAW_CLASS_FIELDS, Scenario, ScenarioBatch,
                                    Solution, deadline_lhs, derive,
                                    neutral_class_values, objective,
                                    pad_scenario, stack_scenarios)

__all__ = [
    "BatchSolveReport", "BatchWarmStart", "CapacityEngine",
    "CrossCheckPolicy", "InfeasibleError", "IntegerSolution", "Policies",
    "RAW_CLASS_FIELDS", "RoundingPolicy", "Scenario", "ScenarioBatch",
    "Solution", "SolveReport", "SolverConfig", "WindowSession",
    "cm_best_response", "cm_bid_update", "cold_start", "deadline_lhs",
    "derive", "kkt_residual", "neutral_class_values", "objective",
    "objective_of_r", "pad_scenario", "rm_solve", "round_solution",
    "round_solution_batch", "sample_class_params", "sample_scenario",
    "solve_centralized", "solve_centralized_batch", "solve_distributed",
    "solve_distributed_batch", "solve_distributed_python", "stack_scenarios",
]
