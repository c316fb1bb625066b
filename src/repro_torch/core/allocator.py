"""DEPRECATED facades over :mod:`repro_torch.core.engine` (the session API).

Counterpart of ``repro.core.allocator``.  Every ``solve_*`` function maps
its legacy keyword arguments onto a
:class:`~repro_torch.core.engine.CapacityEngine` on its input's device (the
Scenario's, the batch's or the window's) and delegates; results are bit for
bit the corresponding engine call.  Each call emits a
:class:`DeprecationWarning`.  Nothing in the package calls these facades:
``EventEpoch.flush`` goes through ``engine._legacy_solve_window``, which
warns about nothing.

The legacy result names are the report classes themselves:
``AllocationResult`` is :class:`~repro_torch.core.engine.SolveReport`,
``BatchAllocationResult`` :class:`~repro_torch.core.engine.BatchSolveReport`
and ``StreamingResult`` :class:`~repro_torch.core.engine.WindowSolveReport`.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

from repro_torch.core.engine import (BatchSolveReport, CapacityEngine,
                                     CrossCheckPolicy, InfeasibleError,
                                     Policies, RoundingPolicy, SolveReport,
                                     SolverConfig, WindowSolveReport,
                                     _legacy_solve_window)
from repro_torch.core.streaming import AdmissionWindow, FlushPolicy
from repro_torch.core.types import Scenario, ScenarioBatch

#: Legacy result names: aliases of the report classes.
AllocationResult = SolveReport
BatchAllocationResult = BatchSolveReport
StreamingResult = WindowSolveReport

__all__ = [
    "AllocationResult", "BatchAllocationResult", "InfeasibleError",
    "StreamingResult", "solve", "solve_batch", "solve_coalesced",
    "solve_streaming",
]


def _warn(name: str, hint: str) -> None:
    """Emit the facade's DeprecationWarning, naming the engine call that
    replaces it."""
    warnings.warn(
        f"repro_torch.core.allocator.{name} is deprecated; use "
        f"repro_torch.core.engine.CapacityEngine — {hint}",
        DeprecationWarning, stacklevel=3)


def _device_of(problem):
    """The device a facade's engine runs on: its input's."""
    if isinstance(problem, Scenario):
        return problem.A.device
    if isinstance(problem, ScenarioBatch):
        return problem.device
    items = list(problem)
    if not items or not isinstance(items[0], Scenario):
        raise TypeError("pass a Scenario, a Sequence[Scenario] or a "
                        "ScenarioBatch")
    return items[0].A.device


def solve(scn: Scenario, method: str = "distributed", *, eps_bar: float = 0.03,
          lam: float = 0.05, max_iters: int = 200,
          integer: bool = True) -> SolveReport:
    """Deprecated: solve one instance (delegates to ``CapacityEngine``).

    Parameters
    ----------
    scn : Scenario
        One allocation instance; the engine runs on its device.
    method : str, optional
        ``"centralized"``, ``"distributed"`` or ``"distributed-python"``.
    eps_bar, lam, max_iters
        Algorithm 4.1 knobs (-> ``SolverConfig``).
    integer : bool, optional
        Apply Algorithm 4.2 rounding (-> ``RoundingPolicy``).

    Returns
    -------
    SolveReport
        Bit for bit ``CapacityEngine(config, policies,
        device=...).solve(scn, method=method)``.

    Raises
    ------
    InfeasibleError
        If ``sum(r_low) > R`` or some deadline is unattainable (E_i >= 0).
    """
    _warn("solve", "CapacityEngine(SolverConfig(...)).solve(scn)")
    eng = CapacityEngine(
        SolverConfig(eps_bar=eps_bar, lam=lam, max_iters=max_iters),
        Policies(rounding=RoundingPolicy(integer)), device=_device_of(scn))
    return eng.solve(scn, method=method)


def solve_batch(batch: Union[ScenarioBatch, Sequence[Scenario]],
                method: str = "distributed", *, eps_bar: float = 0.03,
                lam: float = 0.05, max_iters: int = 200, integer: bool = True,
                sweep_fn=None, mesh=None,
                check_feasible: bool = True) -> BatchSolveReport:
    """Deprecated: solve B instances at once (delegates to the engine).

    Parameters
    ----------
    batch : ScenarioBatch or Sequence[Scenario]
        A prepared batch or a plain (possibly ragged) scenario list; the
        engine runs on its device.
    method : str, optional
        Only ``"distributed"`` is supported on the batched path.
    eps_bar, lam, max_iters
        Algorithm 4.1 knobs (-> ``SolverConfig``).
    integer : bool, optional
        Apply the batched Algorithm 4.2 rounding.
    sweep_fn : callable, optional
        Batched RM price-sweep plug-in (-> ``SolverConfig.sweep_fn``).
    mesh : repro_torch.core.sharding.LaneMesh, optional
        1-D lane mesh (-> ``SolverConfig.mesh``).
    check_feasible : bool, optional
        Raise on infeasible lanes (default) or return per-lane flags.

    Returns
    -------
    BatchSolveReport
        Bit for bit the corresponding ``CapacityEngine.solve`` call.
    """
    _warn("solve_batch",
          "CapacityEngine(SolverConfig(sweep_fn=..., mesh=...)).solve(batch)")
    eng = CapacityEngine(
        SolverConfig(eps_bar=eps_bar, lam=lam, max_iters=max_iters,
                     sweep_fn=sweep_fn, mesh=mesh),
        Policies(rounding=RoundingPolicy(integer)), device=_device_of(batch))
    return eng.solve(batch, method=method, check_feasible=check_feasible)


def solve_streaming(window: AdmissionWindow, *, eps_bar: float = 0.03,
                    lam: float = 0.05, max_iters: int = 200,
                    integer: bool = True, sweep_fn=None, mesh=None,
                    cross_check: bool = False,
                    cross_check_atol: float = 1e-6) -> WindowSolveReport:
    """Deprecated: warm incremental window re-solve (-> ``WindowSession``).

    Parameters
    ----------
    window : AdmissionWindow
        The live window; its equilibrium is committed and its dirty flags
        cleared, as the engine path does.  The engine runs on its device.
    eps_bar, lam, max_iters, sweep_fn, mesh
        Solver knobs and placement (-> ``SolverConfig``).
    integer : bool, optional
        Apply Algorithm 4.2 rounding (-> ``RoundingPolicy``).
    cross_check : bool, optional
        Attach the per-lane exact centralized (P3) gap
        (-> ``CrossCheckPolicy``).
    cross_check_atol : float, optional
        Slack of the cross-check (-> ``CrossCheckPolicy.atol``).

    Returns
    -------
    WindowSolveReport
        Bit for bit ``engine.open_window(window).solve()`` under the same
        config and policies.
    """
    _warn("solve_streaming",
          "CapacityEngine(...).open_window(window).solve()")
    return _legacy_solve_window(window, eps_bar=eps_bar, lam=lam,
                                max_iters=max_iters, integer=integer,
                                sweep_fn=sweep_fn, mesh=mesh,
                                cross_check=cross_check,
                                cross_check_atol=cross_check_atol)


def solve_coalesced(window: AdmissionWindow, events, *,
                    policy: Optional[FlushPolicy] = None,
                    eps_bar: float = 0.03, lam: float = 0.05,
                    max_iters: int = 200, integer: bool = True,
                    sweep_fn=None, mesh=None, cross_check: bool = False):
    """Deprecated: coalesced event-stream replay (-> ``WindowSession.stream``).

    Parameters
    ----------
    window : AdmissionWindow
        The live window; mutated at every flush.  The engine runs on its
        device.
    events : iterable of StreamEvent
        The event stream, in application order.
    policy : FlushPolicy, optional
        Flush triggers (default: every 8 events) (-> ``Policies.flush``).
    eps_bar, lam, max_iters, integer, sweep_fn, mesh, cross_check
        As in :func:`solve_streaming`.

    Returns
    -------
    iterator of WindowSolveReport
        One report per flush, in stream order: bit for bit
        ``engine.open_window(window).stream(events)``.
    """
    _warn("solve_coalesced",
          "CapacityEngine(...).open_window(window).stream(events)")
    eng = CapacityEngine(
        SolverConfig(eps_bar=eps_bar, lam=lam, max_iters=max_iters,
                     sweep_fn=sweep_fn, mesh=mesh),
        Policies(flush=policy if policy is not None else FlushPolicy(),
                 rounding=RoundingPolicy(integer),
                 cross_check=CrossCheckPolicy(cross_check)),
        device=window.device)
    return eng.open_window(window).stream(events)
