"""Session API over the GNEP solver stack: one engine, one config (PyTorch).

Counterpart of ``repro.core.engine``:

* :class:`SolverConfig` — every Algorithm 4.1 knob plus the kernel plug-ins
  in one frozen object, with the reference's
  :meth:`~SolverConfig.fingerprint` strings;
* :class:`Policies` — flush cadence (:class:`~repro_torch.core.streaming
  .FlushPolicy`), compaction (:class:`CompactionPolicy`), Algorithm 4.2
  rounding and the centralized (P3) cross-check;
* :class:`CapacityEngine` — :meth:`~CapacityEngine.solve` for one instance
  or a batch and :meth:`~CapacityEngine.open_window` for the paper's runtime
  loop, on the engine's device (the card unless asked otherwise);
* :class:`WindowSession` — the live loop: ``apply`` events, ``flush``
  coalesced warm re-solves, ``stream`` whole traces.

A ``mesh=`` (``sharding.lane_mesh``) splits every batched solve into lane
slices, each with its own loop; ``residency="resident"`` keeps a session's
window padded on that mesh across flushes.  ``_legacy_solve_window`` maps
the deprecated ``allocator`` facades' keyword arguments onto an engine.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, replace
from typing import (Any, Callable, Iterable, Iterator, List, Optional,
                    Sequence, Set, Tuple, Union)

import numpy as np
import torch

from repro_torch.core import game, sharding
from repro_torch.core.centralized import (solve_centralized,
                                          solve_centralized_batch)
from repro_torch.core.rounding import (IntegerSolution, round_solution,
                                       round_solution_batch)
from repro_torch.core.streaming import AdmissionWindow, FlushPolicy
from repro_torch.core.types import (ClassArrival, Scenario, ScenarioBatch,
                                    SLAEdit, Solution, StreamEvent,
                                    stack_scenarios)
from repro_torch.utils import resolve_device, tree_map


class InfeasibleError(RuntimeError):
    """Deadlines/SLAs cannot be met with the available capacity."""


class QuotaExceededError(RuntimeError):
    """A session operation would exceed its :class:`TenantQuota`.

    Raised by :meth:`WindowSession.offer` (event budget) and
    :meth:`WindowSession.add_lane` (lane budget).
    """


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission budget enforced by a :class:`WindowSession`.

    Attributes
    ----------
    max_queued : int, optional
        Upper bound on the session's buffered, not-yet-flushed events.
    max_lanes : int, optional
        Upper bound on the window's lanes (:meth:`WindowSession.add_lane`
        refuses to grow past it).  ``None`` fields are unlimited.
    """
    max_queued: Optional[int] = None
    max_lanes: Optional[int] = None

    def admits_event(self, n_queued: int) -> bool:
        """Whether one more event fits under ``max_queued``."""
        return self.max_queued is None or n_queued < self.max_queued

    def admits_lane(self, n_lanes: int) -> bool:
        """Whether one more lane fits under ``max_lanes``."""
        return self.max_lanes is None or n_lanes < self.max_lanes


# --------------------------------------------------------------------------
# Configuration: every solver knob in one frozen object
# --------------------------------------------------------------------------


_F32_CHECKED_RE = re.compile(r"f32_checked(?:\[:([1-9]\d*)\])?$")


def _parse_dtype_policy(policy: str):
    """``("f64", None)``, ``("f32_checked", k)`` (k defaults to 4), or None
    when ``policy`` is not a valid ``SolverConfig.dtype_policy``."""
    if policy == "f64":
        return ("f64", None)
    m = _F32_CHECKED_RE.fullmatch(policy)
    if m:
        return ("f32_checked", int(m.group(1)) if m.group(1) else 4)
    return None


def _torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype or its name (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype), None)
    if not isinstance(found, torch.dtype):
        raise TypeError(f"unknown dtype {dtype!r}")
    return found


@dataclass(frozen=True)
class SolverConfig:
    """Every Algorithm 4.1 knob and kernel choice in one object.

    Attributes
    ----------
    eps_bar : float
        Algorithm 4.1 stopping tolerance on the relative allocation change
        (paper uses 0.03).
    lam : float
        Bid-escalation step of ``game.cm_bid_update``.
    max_iters : int
        Best-reply iteration cap.
    dtype : torch.dtype or str, optional
        Float dtype scenario leaves are cast to; ``None`` keeps each input's
        own.  Mutually exclusive with ``dtype_policy``.
    sweep_fn : callable, optional
        Batched RM price sweep, e.g. ``kernels.gnep_sweep.ops
        .make_batched_sweep_fn()`` (the CUDA kernel on the card).
    mesh : repro_torch.core.sharding.LaneMesh, optional
        1-D lane mesh (``sharding.lane_mesh``) whose first device is the
        engine's: batched and window solves split the lanes into one slice
        a device, each with its own loop.
    residency : str
        ``"round-trip"`` (default: a window flush builds its batch and warm
        start at the logical lane count) or ``"resident"`` (the window is
        kept padded on ``mesh`` across flushes; needs a mesh).
    iter_fn : object, optional
        Fused-iteration plug-in, e.g. ``kernels.gnep_iter.ops
        .make_fused_iter_fn()``; takes precedence over ``sweep_fn``.
    dtype_policy : str, optional
        ``"f64"`` or ``"f32_checked[:k]"``: the float32 path with ``k``
        sample lanes re-solved in float64 on the unfused path, raising when
        one deviates beyond ``2 * eps_bar`` relative.
    """
    eps_bar: float = 0.03
    lam: float = 0.05
    max_iters: int = 200
    dtype: Optional[Any] = None
    sweep_fn: Optional[Callable] = None
    mesh: Optional[Any] = None
    residency: str = "round-trip"
    iter_fn: Optional[Any] = None
    dtype_policy: Optional[str] = None

    def __post_init__(self):
        if self.dtype_policy is None:
            return
        if self.dtype is not None:
            raise ValueError(
                "dtype= and dtype_policy= are mutually exclusive — "
                "dtype_policy subsumes the cast (use dtype_policy alone)")
        if _parse_dtype_policy(self.dtype_policy) is None:
            raise ValueError(
                f"unknown dtype_policy {self.dtype_policy!r} — expected "
                "'f64', 'f32_checked' or 'f32_checked[:k]' with k >= 1")

    def effective_dtype(self) -> Optional[torch.dtype]:
        """The dtype scenario leaves are cast to (None = keep native)."""
        if self.dtype_policy is None:
            return None if self.dtype is None else _torch_dtype(self.dtype)
        mode, _ = _parse_dtype_policy(self.dtype_policy)
        return torch.float64 if mode == "f64" else torch.float32

    def check_sample(self) -> int:
        """Sample-lane count of the ``f32_checked`` cross-check (0 if the
        policy does not check)."""
        if self.dtype_policy is None:
            return 0
        mode, k = _parse_dtype_policy(self.dtype_policy)
        return k if mode == "f32_checked" else 0

    def fingerprint(self) -> str:
        """Stable identity string, the same as the JAX package's for the
        same knobs: ``eps_bar=..|lam=..|max_iters=..|dtype=..|sweep=..
        |mesh=..`` plus ``|residency=..`` / ``|iter=..`` / ``|dtype_policy=..``
        when those are not the defaults."""
        dtype = ("native" if self.dtype is None
                 else str(_torch_dtype(self.dtype)).removeprefix("torch."))
        sweep = ("reference" if self.sweep_fn is None
                 else getattr(self.sweep_fn, "__name__",
                              type(self.sweep_fn).__name__))
        mesh = ("none" if self.mesh is None
                else "x".join(map(str, self.mesh.devices.shape))
                + ":" + ",".join(self.mesh.axis_names))
        tail = ("" if self.residency == "round-trip"
                else f"|residency={self.residency}")
        if self.iter_fn is not None:
            tail += "|iter=" + getattr(self.iter_fn, "__name__",
                                       type(self.iter_fn).__name__)
        if self.dtype_policy is not None:
            tail += f"|dtype_policy={self.dtype_policy}"
        return (f"eps_bar={self.eps_bar}|lam={self.lam}"
                f"|max_iters={self.max_iters}|dtype={dtype}"
                f"|sweep={sweep}|mesh={mesh}{tail}")


# --------------------------------------------------------------------------
# Policies
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RoundingPolicy:
    """Whether Algorithm 4.2 integerization runs after the solve."""
    enabled: bool = True


@dataclass(frozen=True)
class CrossCheckPolicy:
    """Compare every window lane against its exact centralized (P3) optimum.

    Window solves attach the per-lane relative gap of the GNEP total over
    the exact optimum (``WindowSolveReport.centralized_gap``), recomputing
    the optimum only for lanes whose scenario changed.  ``atol`` is the
    absolute slack allowed before a feasible lane's GNEP total undercutting
    the exact optimum raises ``RuntimeError``.
    """
    enabled: bool = False
    atol: float = 1e-6


@dataclass(frozen=True)
class CompactionPolicy:
    """When a :class:`WindowSession` re-packs its sparse window.

    At every flush, after the buffered events are folded in, the session
    compacts (``AdmissionWindow.compact``) when ``window.occupancy`` is
    below ``occupancy``; the report carries the old -> new ``slot_map``.

    Attributes
    ----------
    occupancy : float, optional
        Occupied-slot fraction below which the session compacts; ``None``
        (default) never compacts on its own.
    headroom : float
        The compacted width is ``ceil(headroom * widest lane)`` (at least
        the widest lane).
    """
    occupancy: Optional[float] = None
    headroom: float = 1.0


@dataclass(frozen=True)
class Policies:
    """The engine's operational policy bundle: flush cadence, compaction,
    rounding and the centralized cross-check."""
    flush: FlushPolicy = FlushPolicy()
    compaction: CompactionPolicy = CompactionPolicy()
    rounding: RoundingPolicy = RoundingPolicy()
    cross_check: CrossCheckPolicy = CrossCheckPolicy()


# --------------------------------------------------------------------------
# Reports
# --------------------------------------------------------------------------


@dataclass
class SolveReport:
    """One solved instance.

    Attributes
    ----------
    method : str
        ``"centralized"``, ``"distributed"``, ``"distributed-python"`` or
        ``"distributed-batch"``.
    fractional : Solution
        The fractional equilibrium / optimum.
    integer : IntegerSolution or None
        Algorithm 4.2 integerization (None when rounding is disabled).
    iters : int or torch.Tensor
        Best-reply iterations (per lane for batched reports).
    config : SolverConfig or None
        The solver config that produced this report.
    elapsed_s : float
        Host wall-clock of the engine call.  The solve reads its loop
        condition back every iteration, so the device work is done.
    """
    method: str
    fractional: Solution
    integer: Optional[IntegerSolution]
    iters: Any
    config: Optional[SolverConfig] = None
    elapsed_s: float = 0.0

    @property
    def r(self):
        """Allocation of the preferred (integer when present) solution."""
        return self.integer.r if self.integer is not None else self.fractional.r

    @property
    def total(self):
        """Objective total of the preferred solution."""
        return (self.integer.total if self.integer is not None
                else self.fractional.total)

    @property
    def converged(self):
        """Whether Algorithm 4.1 stopped on tolerance, not the iteration cap
        (per lane for batched reports)."""
        limit = self.config.max_iters if self.config is not None else np.inf
        return self.iters < limit


@dataclass
class BatchSolveReport(SolveReport):
    """One batched solve: every leaf carries a leading B dim.

    Attributes (beyond :class:`SolveReport`)
    ----------------------------------------
    mask : torch.Tensor
        (B, n_max) class-validity mask of the solved batch.
    n_classes : torch.Tensor
        (B,) valid-class counts.
    feasible : torch.Tensor
        (B,) per-lane feasibility flags.
    dtype_check : dict or None
        The ``f32_checked`` measurement (``lanes``, ``max_rel``, ``bound``).
    """
    mask: Optional[torch.Tensor] = None
    n_classes: Optional[torch.Tensor] = None
    feasible: Optional[torch.Tensor] = None
    dtype_check: Optional[dict] = None

    @property
    def batch_size(self) -> int:
        return self.mask.shape[0]

    def instance(self, b: int) -> SolveReport:
        """Trim lane ``b`` to a single-instance view (gathers valid slots
        through the mask)."""
        sel = self.mask[b]

        def pick(leaf):
            leaf = leaf[b]
            return leaf[sel] if leaf.ndim else leaf

        frac = tree_map(pick, self.fractional)
        integ = (tree_map(pick, self.integer)
                 if self.integer is not None else None)
        return SolveReport(method=self.method, fractional=frac, integer=integ,
                           iters=int(self.iters[b]), config=self.config,
                           elapsed_s=self.elapsed_s)


@dataclass
class WindowSolveReport(BatchSolveReport):
    """One window re-solve: a batch report plus incremental bookkeeping.

    Attributes (beyond :class:`BatchSolveReport`)
    ---------------------------------------------
    resolved : np.ndarray
        (B,) bool — lanes that iterated this solve (dirty or never solved);
        the others were frozen at their stored equilibrium.
    centralized_gap : torch.Tensor or None
        (B,) relative gap of the fractional GNEP total over the exact (P3)
        optimum, when the cross-check policy is enabled.
    slot_map : np.ndarray or None
        (B, old_n_max) old-slot -> new-slot map when this flush compacted
        the window under a :class:`CompactionPolicy` (None otherwise).
    """
    resolved: Optional[np.ndarray] = None
    centralized_gap: Optional[torch.Tensor] = None
    slot_map: Optional[np.ndarray] = None


# --------------------------------------------------------------------------
# Input coercion
# --------------------------------------------------------------------------


def _coerce(problem, *, dtype=None, n_max: Optional[int] = None,
            device="cuda") -> ScenarioBatch:
    """Normalize any accepted problem form into a :class:`ScenarioBatch`
    on ``device``.

    Parameters
    ----------
    problem : ScenarioBatch, Scenario, Sequence[Scenario] or AdmissionWindow
        A prepared batch, a single instance (stacked as one lane), a plain
        — possibly ragged — scenario list (stacked/padded here) or a live
        window (its current batch).
    dtype : torch.dtype or str, optional
        Cast every float leaf to this dtype; ``None`` keeps the input's.
    n_max : int, optional
        Padded width when stacking loose scenarios.
    device : str or torch.device
        Where the batch is placed (default the card).

    Raises
    ------
    TypeError
        For anything else (with the accepted forms named).
    """
    dev = resolve_device(device)
    if isinstance(problem, AdmissionWindow):
        problem = problem.batch
    if isinstance(problem, ScenarioBatch):
        batch = tree_map(lambda t: t.to(dev), problem)
    elif isinstance(problem, Scenario):
        batch = stack_scenarios([problem], n_max=n_max, device=dev)
    elif isinstance(problem, Sequence) and not isinstance(problem, (str, bytes)):
        items = list(problem)
        if not all(isinstance(s, Scenario) for s in items):
            raise TypeError(
                "sequence inputs must contain Scenario instances only")
        batch = stack_scenarios(items, n_max=n_max, device=dev)
    else:
        raise TypeError(
            f"cannot coerce {type(problem).__name__!r} — pass a Scenario, a "
            "Sequence[Scenario], a ScenarioBatch or an AdmissionWindow")
    if dtype is not None:
        batch = ScenarioBatch(scenarios=_cast_floats(batch.scenarios, dtype),
                              mask=batch.mask, n_classes=batch.n_classes)
    return batch


def _cast_floats(tree, dtype):
    """Cast every floating tensor of ``tree`` to ``dtype``; integer and bool
    tensors pass through."""
    dt = _torch_dtype(dtype)
    return tree_map(lambda t: t.to(dt) if t.is_floating_point() else t, tree)


def _dtype_check(cfg: SolverConfig, batch: ScenarioBatch, sol: Solution,
                 masks=None) -> Optional[dict]:
    """The ``dtype_policy="f32_checked"`` cross-check of a batched solve.

    Re-solves ``cfg.check_sample()`` evenly-spaced sample lanes in float64
    on the unfused plain path and holds each lane's relative L1 allocation
    deviation to ``2 * cfg.eps_bar`` (plus 1e-6).  ``masks``, a (B,) host
    bool array, restricts the sample to the lanes it flags (windows pass
    the lanes that hold a class); None samples every lane.

    Returns
    -------
    dict or None
        ``{"lanes": [...], "max_rel": float, "bound": float}``; None when
        the policy does not check or no lane is eligible.

    Raises
    ------
    RuntimeError
        Naming the offending lanes when a sampled lane deviates too far.
    """
    k = cfg.check_sample()
    if k == 0:
        return None
    eligible = (np.arange(batch.batch_size) if masks is None
                else np.flatnonzero(np.asarray(masks)))
    if eligible.size == 0:
        return None
    k = min(k, eligible.size)
    pick = np.unique(np.linspace(0, eligible.size - 1, k).round().astype(int))
    lanes = [int(b) for b in eligible[pick]]

    sub = batch.take(lanes)
    sub64 = ScenarioBatch(scenarios=_cast_floats(sub.scenarios, torch.float64),
                          mask=sub.mask, n_classes=sub.n_classes)
    ref = game.solve_distributed_batch(sub64, eps_bar=cfg.eps_bar,
                                       lam=cfg.lam, max_iters=cfg.max_iters)
    r32 = sol.r[torch.as_tensor(lanes, device=sol.r.device)].to(torch.float64)
    dev = torch.abs(r32 - ref.r).sum(1)
    scale = torch.clamp(torch.abs(ref.r).sum(1), min=1.0)
    rel = (dev / scale).cpu().numpy()
    bound = 2.0 * cfg.eps_bar + 1e-6
    if np.any(rel > bound):
        bad = [lanes[i] for i in np.flatnonzero(rel > bound)]
        raise RuntimeError(
            f"dtype_policy={cfg.dtype_policy!r}: lanes {bad} deviate from "
            f"the f64 reference beyond {bound:.3g} relative "
            f"(worst {float(rel.max()):.3g}) — the f32 fast path is not "
            "trustworthy for this workload; use dtype_policy='f64'")
    return {"lanes": lanes, "max_rel": float(rel.max()), "bound": bound}


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------


class CapacityEngine:
    """The entry point to the GNEP capacity-allocation stack.

    Parameters
    ----------
    config : SolverConfig, optional
        Solver knobs + kernel plug-ins (defaults: the paper's, plain path).
    policies : Policies, optional
        Operational policies (default: round, no cross-check).
    device : str or torch.device
        Where problems are placed and solved (default the card; pass
        ``"cpu"`` to solve on the CPU).
    """

    def __init__(self, config: Optional[SolverConfig] = None,
                 policies: Optional[Policies] = None, *, device="cuda"):
        self.config = config if config is not None else SolverConfig()
        self.policies = policies if policies is not None else Policies()
        self.device = resolve_device(device)
        if self.config.residency not in ("round-trip", "resident"):
            raise ValueError(
                f"unknown residency {self.config.residency!r} — "
                "expected 'round-trip' or 'resident'")
        if self.config.residency == "resident" and self.config.mesh is None:
            raise ValueError(
                "residency='resident' needs a mesh= in the SolverConfig "
                "(repro_torch.core.sharding.lane_mesh)")
        if (self.config.check_sample() > 0
                and self.config.residency == "resident"):
            # as in the reference: the check's f64 shadow re-solve is made
            # at the logical lane count, so resident sessions refuse it
            # rather than weaken it
            raise ValueError(
                "dtype_policy='f32_checked' is not supported with "
                "residency='resident' — use residency='round-trip' for "
                "checked f32, or dtype_policy='f64' for resident sessions")

    # ------------------------------------------------------------- one-shot
    def solve(self, problem, *, method: str = "distributed",
              check_feasible: bool = True
              ) -> Union[SolveReport, BatchSolveReport]:
        """Solve one instance or one batch of independent instances.

        Parameters
        ----------
        problem : Scenario, Sequence[Scenario] or ScenarioBatch
            A single :class:`Scenario` runs the single-instance pipeline
            (any ``method``); everything else is coerced by :func:`_coerce`
            and runs the batched engine.  Inputs are moved to the engine's
            device.
        method : str, optional
            ``"distributed"`` (Algorithm 4.1, default), ``"centralized"``
            or ``"distributed-python"`` (single instances only).
        check_feasible : bool, optional
            Batched path: True raises :class:`InfeasibleError` naming every
            infeasible lane; False returns per-lane ``feasible`` flags.

        Raises
        ------
        InfeasibleError
            If ``sum(r_low) > R`` or some E_i >= 0.
        ValueError
            For an unknown or unsupported ``method``.
        """
        if isinstance(problem, Scenario):
            return self._solve_single(
                tree_map(lambda t: t.to(self.device), problem), method)
        if method != "distributed":
            raise ValueError("batched solves support method='distributed' "
                             f"only, got {method!r}")
        return self._solve_batch(
            _coerce(problem, dtype=self.config.effective_dtype(),
                    device=self.device),
            check_feasible)

    def _solve_single(self, scn: Scenario, method: str) -> SolveReport:
        cfg = self.config
        if cfg.effective_dtype() is not None:
            scn = _cast_floats(scn, cfg.effective_dtype())
        t0 = time.perf_counter()
        if method == "centralized":
            sol = solve_centralized(scn)
        elif method == "distributed":
            sol = game.solve_distributed(scn, eps_bar=cfg.eps_bar,
                                         lam=cfg.lam,
                                         max_iters=cfg.max_iters)
        elif method == "distributed-python":
            sol, _, _ = game.solve_distributed_python(
                scn, eps_bar=cfg.eps_bar, lam=cfg.lam,
                max_iters=cfg.max_iters)
        else:
            raise ValueError(f"unknown method {method!r}")

        if not bool(sol.feasible):
            raise InfeasibleError(
                "instance infeasible: "
                f"sum(r_low)={float(scn.r_low.sum()):.1f} "
                f"> R={float(scn.R):.1f} or some E_i >= 0")

        if cfg.check_sample() > 0 and method == "distributed":
            # single-instance flavor of _dtype_check: one f64 re-solve
            sol64 = game.solve_distributed(
                _cast_floats(scn, torch.float64), eps_bar=cfg.eps_bar,
                lam=cfg.lam, max_iters=cfg.max_iters)
            dev = float(torch.abs(sol.r.to(torch.float64) - sol64.r).sum())
            scale = max(float(torch.abs(sol64.r).sum()), 1.0)
            bound = 2.0 * cfg.eps_bar + 1e-6
            if dev / scale > bound:
                raise RuntimeError(
                    f"dtype_policy={cfg.dtype_policy!r}: instance deviates "
                    f"from the f64 reference beyond {bound:.3g} relative "
                    f"({dev / scale:.3g}) — use dtype_policy='f64'")

        integer_sol = (round_solution(scn, sol.r, sol.sM, sol.sR, sol.psi)
                       if self.policies.rounding.enabled else None)
        return SolveReport(method=method, fractional=sol, integer=integer_sol,
                           iters=int(sol.iters), config=cfg,
                           elapsed_s=time.perf_counter() - t0)

    def _solve_batch(self, batch: ScenarioBatch,
                     check_feasible: bool) -> BatchSolveReport:
        cfg = self.config
        t0 = time.perf_counter()
        sol = game.solve_distributed_batch(batch, eps_bar=cfg.eps_bar,
                                           lam=cfg.lam,
                                           max_iters=cfg.max_iters,
                                           sweep_fn=cfg.sweep_fn,
                                           mesh=cfg.mesh,
                                           iter_fn=cfg.iter_fn)
        if check_feasible and not bool(sol.feasible.all()):
            bad = [int(b) for b in torch.nonzero(~sol.feasible)[:, 0]]
            raise InfeasibleError(f"instances {bad} infeasible: "
                                  "sum(r_low) > R or some E_i >= 0")
        dtype_check = _dtype_check(cfg, batch, sol)

        integer_sol = (round_solution_batch(batch, sol.r, sol.sM, sol.sR,
                                            sol.psi)
                       if self.policies.rounding.enabled else None)
        return BatchSolveReport(method="distributed", fractional=sol,
                                integer=integer_sol, iters=sol.iters,
                                config=cfg,
                                elapsed_s=time.perf_counter() - t0,
                                mask=batch.mask, n_classes=batch.n_classes,
                                feasible=sol.feasible,
                                dtype_check=dtype_check)


    # ------------------------------------------------------------ sessions
    def open_window(self, lanes, *, n_max: Optional[int] = None,
                    growth_factor: float = 2.0,
                    quota: Optional[TenantQuota] = None) -> "WindowSession":
        """Open the runtime loop: a live window driven by this engine.

        Parameters
        ----------
        lanes : AdmissionWindow, Scenario, Sequence[Scenario] or ScenarioBatch
            An existing window is adopted as it is (its state, occupancy and
            dirty flags kept); anything else is coerced by :func:`_coerce`
            onto the engine's device into the lanes of a fresh
            :class:`~repro_torch.core.streaming.AdmissionWindow`.
        n_max : int, optional
            Initial padded width of a fresh window (default: the coerced
            batch's); ignored when adopting a window.
        growth_factor : float, optional
            Fresh-window growth multiplier when a lane's row fills.
        quota : TenantQuota, optional
            Budget the session enforces on ``offer`` and ``add_lane``; the
            initial lane count must already fit it.

        Returns
        -------
        WindowSession
            The session; solver and policy behaviour come from this engine.
        """
        if isinstance(lanes, AdmissionWindow):
            return WindowSession(self, lanes, quota=quota)
        batch = _coerce(lanes, dtype=self.config.effective_dtype(),
                        device=self.device)
        scns = [batch.instance(b) for b in range(batch.batch_size)]
        window = AdmissionWindow(scns, n_max=n_max or batch.n_max,
                                 growth_factor=growth_factor)
        return WindowSession(self, window, quota=quota)

    # ----------------------------------------------------------- internals
    def _solve_window(self, window: AdmissionWindow) -> WindowSolveReport:
        """Warm-started incremental re-solve of a live window, where its
        tensors lie: only dirty lanes iterate, clean lanes pass through at
        their stored equilibrium.  A resident window (or a
        ``residency='resident'`` config, which makes the window resident on
        first use) takes the resident path."""
        cfg = self.config
        if not window.is_resident and cfg.residency == "resident":
            window.make_resident(cfg.mesh)
        if window.is_resident:
            if cfg.mesh is not None and cfg.mesh != window.resident_mesh:
                raise ValueError(
                    "window is resident on a different mesh than the "
                    "engine's config.mesh — release_resident or match them")
            return self._solve_window_resident(window)
        return self._solve_window_roundtrip(window)

    def _solve_window_roundtrip(self,
                                window: AdmissionWindow) -> WindowSolveReport:
        """The round-trip flush: the warm start built at the logical lane
        count, split over ``config.mesh`` per solve when one is set."""
        cfg = self.config
        t0 = time.perf_counter()
        batch = window.batch
        init = window.warm_start()
        resolved = init.active.cpu().numpy().copy()

        sol = game.solve_distributed_batch(batch, eps_bar=cfg.eps_bar,
                                           lam=cfg.lam,
                                           max_iters=cfg.max_iters,
                                           sweep_fn=cfg.sweep_fn, init=init,
                                           mesh=cfg.mesh, iter_fn=cfg.iter_fn)
        window.commit(sol.r, sol.aux, sol.iters)
        dtype_check = _dtype_check(cfg, batch, sol,
                                   masks=window._mask.any(axis=1))
        return self._window_report(window, batch, sol, resolved, t0,
                                   dtype_check=dtype_check)

    def _solve_window_resident(self,
                               window: AdmissionWindow) -> WindowSolveReport:
        """The resident flush: the padded batch, mask mirror and stored
        equilibrium already lie on the window's mesh; the warm start is
        built there, the padded solution is committed, and the report is
        trimmed to the logical lanes."""
        cfg = self.config
        t0 = time.perf_counter()
        rbatch = window.resident_batch()
        init, resolved = window.resident_warm_start(rbatch)
        sol_p = sharding.solve_resident_batch(
            rbatch, window.resident_mesh, eps_bar=cfg.eps_bar, lam=cfg.lam,
            max_iters=cfg.max_iters, sweep_fn=cfg.sweep_fn, init=init,
            iter_fn=cfg.iter_fn)
        window.commit(sol_p.r, sol_p.aux, sol_p.iters)
        b = window.batch_size
        sol = (sol_p if rbatch.batch_size == b
               else tree_map(lambda leaf: leaf[:b], sol_p))
        # the report's batch is the logical window, as on the round trip,
        # so the two paths' reports are alike leaf for leaf
        return self._window_report(window, window.batch, sol, resolved, t0)

    def _window_report(self, window: AdmissionWindow, batch: ScenarioBatch,
                       sol: Solution, resolved: np.ndarray, t0: float,
                       dtype_check: Optional[dict] = None
                       ) -> WindowSolveReport:
        """Centralized cross-check, Algorithm 4.2 rounding and the report.

        The exact (P3) optimum of a lane changes only with its scenario, so
        only the stale lanes are solved, all of them in one
        :func:`solve_centralized_batch` (lanes are independent rows of it),
        and the rest come from the window's memo.
        """
        cfg, pol = self.config, self.policies
        gap = None
        if pol.cross_check.enabled:
            stale = np.flatnonzero(window.baseline_stale)
            if stale.size:
                totals = solve_centralized_batch(batch.take(stale)).total
                window.baseline_totals[stale] = (
                    totals.to(torch.float64).cpu().numpy())
            window.baseline_stale[stale] = False
            cent_total = torch.tensor(window.baseline_totals,
                                      dtype=sol.total.dtype,
                                      device=sol.total.device)
            scale = torch.clamp(torch.abs(cent_total), min=1.0)
            gap = (sol.total - cent_total) / scale
            undercut = ((sol.total < cent_total - pol.cross_check.atol)
                        & sol.feasible)
            if bool(undercut.any()):
                bad = [int(b) for b in torch.nonzero(undercut)[:, 0]]
                raise RuntimeError(
                    f"lanes {bad}: GNEP total beats the exact (P3) optimum "
                    "— solver inconsistency (check mask/padding invariants)")

        integer_sol = (round_solution_batch(batch, sol.r, sol.sM, sol.sR,
                                            sol.psi)
                       if pol.rounding.enabled else None)
        return WindowSolveReport(method="streaming", fractional=sol,
                                 integer=integer_sol, iters=sol.iters,
                                 config=cfg,
                                 elapsed_s=time.perf_counter() - t0,
                                 mask=batch.mask, n_classes=batch.n_classes,
                                 feasible=sol.feasible, resolved=resolved,
                                 centralized_gap=gap,
                                 dtype_check=dtype_check)


class WindowSession:
    """The paper's runtime loop as a session: events in, equilibria out.

    Wraps a live :class:`~repro_torch.core.streaming.AdmissionWindow` and
    owns the event buffer and its flush policy, the warm-start state carried
    between re-solves, compaction, rounding and the centralized
    cross-check.  Per-lane ``feasible`` flags report infeasible transients
    without raising.  Obtain sessions from :meth:`CapacityEngine.open_window`.

    Parameters
    ----------
    engine : CapacityEngine
        Supplies ``config`` and ``policies``.
    window : AdmissionWindow
        The live window; mutated by ``apply`` / ``flush`` / lane operations.
    quota : TenantQuota, optional
        Budget ``offer`` and ``add_lane`` enforce with
        :class:`QuotaExceededError`; ``None`` is unlimited.

    Attributes
    ----------
    flushes : int
        Flushes that solved (a no-op echo does not count).
    events_folded : int
        Events applied to the window so far.
    last_slots : list
        Per-event slot grants of the last drain.
    """

    def __init__(self, engine: CapacityEngine, window: AdmissionWindow,
                 quota: Optional[TenantQuota] = None):
        if (quota is not None
                and not quota.admits_lane(window.batch_size - 1)):
            raise QuotaExceededError(
                f"window opens with {window.batch_size} lanes, quota "
                f"allows {quota.max_lanes}")
        self.engine = engine
        self.window = window
        self.quota = quota
        self._pending: List[StreamEvent] = []
        self.flushes = 0
        self.events_folded = 0
        self.last_slots: List[Optional[int]] = []
        self._last_report: Optional[WindowSolveReport] = None

    # ------------------------------------------------------------- queries
    @property
    def pending(self) -> Tuple[StreamEvent, ...]:
        """Buffered, not-yet-applied events (application order)."""
        return tuple(self._pending)

    @property
    def dirty_lanes(self) -> Set[int]:
        """Lanes the next flush will re-solve: window-dirty | buffered."""
        return ({int(b) for b in np.flatnonzero(self.window.dirty)}
                | {ev.lane for ev in self._pending})

    # --------------------------------------------------------------- verbs
    def solve(self) -> WindowSolveReport:
        """Warm-started re-solve of the window as it is (buffered events are
        not applied — :meth:`flush` does that): dirty lanes iterate from the
        cold init, clean lanes are frozen."""
        return self.engine._solve_window(self.window)

    def apply(self, *events: StreamEvent) -> Optional[WindowSolveReport]:
        """Buffer events, flushing whenever the flush policy fires.

        Returns
        -------
        WindowSolveReport or None
            The report of the last flush the events triggered, or None when
            everything is still buffered.
        """
        policy = self.engine.policies.flush
        report = None
        for ev in events:
            self._pending.append(ev)
            if self._policy_fires(policy, ev):
                report = self.flush()
        return report

    def _policy_fires(self, policy: FlushPolicy, ev: StreamEvent) -> bool:
        """One buffered event's flush decision (dirty lanes are counted only
        when the policy has a dirty-fraction trigger)."""
        if policy.is_critical(ev, self.window):
            return True
        n_dirty = (len(self.dirty_lanes)
                   if policy.max_dirty_fraction is not None else 0)
        return policy.should_flush(n_events=len(self._pending),
                                   n_dirty=n_dirty,
                                   batch_size=self.window.batch_size)

    def offer(self, event: StreamEvent) -> bool:
        """Buffer one event without flushing; True when a flush is due.

        The external-scheduler hook: the same policy check as :meth:`apply`,
        with the flush left to the caller.  Once it returns True, offer no
        more events until :meth:`flush` has run.

        Raises
        ------
        QuotaExceededError
            When the buffer already holds the quota's ``max_queued`` events.
        """
        if (self.quota is not None
                and not self.quota.admits_event(len(self._pending))):
            raise QuotaExceededError(
                f"session buffer holds {len(self._pending)} events, quota "
                f"allows {self.quota.max_queued}")
        self._pending.append(event)
        return self._policy_fires(self.engine.policies.flush, event)

    def pending_slack(self) -> float:
        """Tightest SLA slack [s] of the buffered events: ``min(-E)`` over
        arrivals' params and SLA edits' updates that carry ``E``; ``inf``
        when none does."""
        slack = np.inf
        for ev in self._pending:
            E = None
            if isinstance(ev, ClassArrival):
                E = ev.params.get("E")
            elif isinstance(ev, SLAEdit):
                E = ev.updates.get("E")
            if E is not None:
                slack = min(slack, -float(E))
        return slack

    def drain(self) -> List[Optional[int]]:
        """Fold every buffered event into the window without re-solving.

        Returns
        -------
        list of (int or None)
            Per-event slot grants (arrivals) in buffer order — also kept on
            ``last_slots``; empty when nothing was pending.
        """
        if not self._pending:
            return []
        slots = self.window.apply_epoch(self._pending)
        self.events_folded += len(self._pending)
        self._pending = []
        self.last_slots = slots
        return slots

    def discard_pending(self) -> Tuple[StreamEvent, ...]:
        """Drop every buffered event without folding it in; returns them in
        buffer order.  The window is untouched."""
        dropped = tuple(self._pending)
        self._pending = []
        return dropped

    def flush(self) -> WindowSolveReport:
        """Apply buffered events, run policy compaction, re-solve once.

        An empty flush on a clean, solved window whose mask is the last
        report's is a no-op: it echoes that report (``slot_map`` cleared)
        without solving, and ``flushes`` / ``events_folded`` stay.

        Returns
        -------
        WindowSolveReport
            Equal to having re-solved after every single event.
        """
        if (not self._pending and self._last_report is not None
                and self.window.state is not None
                and not self.window.dirty.any()
                and np.array_equal(self._last_report.mask.cpu().numpy(),
                                   self.window._mask)):
            return replace(self._last_report, slot_map=None)
        self.drain()
        report_map = None
        comp = self.engine.policies.compaction
        if (comp.occupancy is not None
                and self.window.occupancy < comp.occupancy):
            widest = max(int(self.window.n_classes.max()), 1)
            target = max(int(np.ceil(comp.headroom * widest)), widest)
            report_map = self.window.compact(n_max=target)
        report = self.engine._solve_window(self.window)
        report.slot_map = report_map
        self.flushes += 1
        self._last_report = report
        return report

    def stream(self, events: Iterable[StreamEvent]
               ) -> Iterator[WindowSolveReport]:
        """Replay an event stream in policy-coalesced flushes, yielding one
        report per flush; a trailing partial epoch is flushed at the end, so
        the window is left clean and solved."""
        for ev in events:
            report = self.apply(ev)
            if report is not None:
                yield report
        if self._pending:
            yield self.flush()

    # ----------------------------------------------------- window geometry
    def add_lane(self, scn: Optional[Scenario] = None, *,
                 R: Optional[float] = None,
                 rho_bar: Optional[float] = None) -> int:
        """Append one lane (buffered events drain first); see
        ``AdmissionWindow.add_lane``.

        Raises
        ------
        QuotaExceededError
            When the window already holds the quota's ``max_lanes``.
        """
        if (self.quota is not None
                and not self.quota.admits_lane(self.window.batch_size)):
            raise QuotaExceededError(
                f"window already holds {self.window.batch_size} lanes, "
                f"quota allows {self.quota.max_lanes}")
        self.drain()
        return self.window.add_lane(scn, R=R, rho_bar=rho_bar)

    def remove_lane(self, lane: int) -> None:
        """Drop ``lane`` and shrink B by one (buffered events drain
        first)."""
        self.drain()
        self.window.remove_lane(lane)

    def compact(self, *, n_max: Optional[int] = None) -> np.ndarray:
        """Re-pack the window now (buffered events drain first); returns the
        (B, old_n_max) old-slot -> new-slot map (-1 where empty)."""
        self.drain()
        return self.window.compact(n_max=n_max)


# --------------------------------------------------------------------------
# Legacy plumbing (no DeprecationWarning: mechanism, not facade)
# --------------------------------------------------------------------------


def _legacy_solve_window(window: AdmissionWindow, *, eps_bar: float = 0.03,
                         lam: float = 0.05, max_iters: int = 200,
                         integer: bool = True, sweep_fn=None, mesh=None,
                         cross_check: bool = False,
                         cross_check_atol: float = 1e-6) -> WindowSolveReport:
    """Keyword arguments -> (config, policies) adapter of the deprecated
    facades and ``EventEpoch.flush``, with the engine on the window's
    device, so that in-package code never goes through a warning shim."""
    eng = CapacityEngine(
        SolverConfig(eps_bar=eps_bar, lam=lam, max_iters=max_iters,
                     sweep_fn=sweep_fn, mesh=mesh),
        Policies(rounding=RoundingPolicy(integer),
                 cross_check=CrossCheckPolicy(cross_check, cross_check_atol)),
        device=window.device)
    return eng._solve_window(window)
