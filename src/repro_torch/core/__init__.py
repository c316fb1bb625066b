"""The paper's runtime allocator in PyTorch (counterpart of ``repro.core``).

The entry point is :class:`CapacityEngine` with :class:`SolverConfig` /
:class:`Policies`, and :class:`WindowSession` for the runtime loop; the
mechanism lives in ``game`` (Algorithm 4.1), ``rounding`` (Algorithm 4.2),
``centralized`` (the exact P3 optimum), ``streaming`` (the admission
window) and ``sharding`` (lane meshes and resident windows).  The
``solve_*`` facades of ``allocator`` remain as deprecated shims.
"""
from repro_torch.core.allocator import (AllocationResult,
                                        BatchAllocationResult,
                                        StreamingResult, solve, solve_batch,
                                        solve_coalesced, solve_streaming)
from repro_torch.core.centralized import (kkt_residual, objective_of_r,
                                          solve_centralized,
                                          solve_centralized_batch)
from repro_torch.core.engine import (BatchSolveReport, CapacityEngine,
                                     CompactionPolicy, CrossCheckPolicy,
                                     InfeasibleError, Policies,
                                     QuotaExceededError, RoundingPolicy,
                                     SolveReport, SolverConfig, TenantQuota,
                                     WindowSession, WindowSolveReport)
from repro_torch.core.game import (BatchWarmStart, cm_best_response,
                                   cm_bid_update, cold_start,
                                   distributed_walltime_estimate, rm_solve,
                                   solve_distributed, solve_distributed_batch,
                                   solve_distributed_python)
from repro_torch.core.profiles import (from_roofline, sample_class_params,
                                       sample_scenario)
from repro_torch.core.rounding import (IntegerSolution, round_solution,
                                       round_solution_batch)
from repro_torch.core.sharding import (LANE_AXIS, lane_mesh, lane_sharding,
                                       pad_batch_lanes, pad_warm_start,
                                       padded_lane_count, shard_batch,
                                       solve_sharded_batch)
from repro_torch.core.streaming import (AdmissionWindow, EventEpoch,
                                        FlushPolicy, grown_n_max, replay,
                                        sample_event_trace)
from repro_torch.core.types import (RAW_CLASS_FIELDS, CapacityChange,
                                    ClassArrival, ClassDeparture, Scenario,
                                    ScenarioBatch, SLAEdit, Solution,
                                    StreamEvent, WindowState, deadline_lhs,
                                    derive, neutral_class_values, objective,
                                    pad_scenario, stack_scenarios)

__all__ = [
    "AdmissionWindow", "AllocationResult", "BatchAllocationResult",
    "BatchSolveReport", "BatchWarmStart", "CapacityChange", "CapacityEngine",
    "ClassArrival", "ClassDeparture", "CompactionPolicy", "CrossCheckPolicy",
    "EventEpoch", "FlushPolicy", "InfeasibleError", "IntegerSolution",
    "LANE_AXIS", "Policies", "QuotaExceededError", "RAW_CLASS_FIELDS",
    "RoundingPolicy", "SLAEdit", "Scenario", "ScenarioBatch", "Solution",
    "SolveReport", "SolverConfig", "StreamEvent", "StreamingResult",
    "TenantQuota", "WindowSession", "WindowSolveReport", "WindowState",
    "cm_best_response", "cm_bid_update", "cold_start", "deadline_lhs",
    "derive", "distributed_walltime_estimate", "from_roofline", "grown_n_max",
    "kkt_residual", "lane_mesh", "lane_sharding", "neutral_class_values",
    "objective", "objective_of_r", "pad_batch_lanes", "pad_scenario",
    "pad_warm_start", "padded_lane_count", "replay", "rm_solve",
    "round_solution", "round_solution_batch", "sample_class_params",
    "sample_event_trace", "sample_scenario", "shard_batch", "solve",
    "solve_batch", "solve_centralized", "solve_centralized_batch",
    "solve_coalesced", "solve_distributed", "solve_distributed_batch",
    "solve_distributed_python", "solve_sharded_batch", "solve_streaming",
    "stack_scenarios",
]
