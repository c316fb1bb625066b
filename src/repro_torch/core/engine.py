"""Session API over the GNEP solver stack: one engine, one config (PyTorch).

Counterpart of ``repro.core.engine``, one-shot path only:

* :class:`SolverConfig` — every Algorithm 4.1 knob plus the kernel plug-ins
  in one frozen object, with the reference's
  :meth:`~SolverConfig.fingerprint` strings;
* :class:`Policies` — Algorithm 4.2 rounding and the centralized (P3)
  cross-check (the flush and compaction policies come with the streaming
  slice, ROADMAP.md Queue 1 item 9);
* :class:`CapacityEngine` — :meth:`~CapacityEngine.solve` for one instance
  or a batch, on the engine's device (the card unless asked otherwise).

Windows (``open_window`` / :class:`WindowSession`) and device-resident
sessions are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import game
from repro_torch.core.centralized import solve_centralized
from repro_torch.core.rounding import (IntegerSolution, round_solution,
                                       round_solution_batch)
from repro_torch.core.types import (Scenario, ScenarioBatch, Solution,
                                    stack_scenarios)
from repro_torch.utils import resolve_device, tree_map

_WINDOWS = ("admission windows are not ported yet (ROADMAP.md Queue 1 "
            "item 9, core/streaming.py)")
_RESIDENT = ("device-resident sessions are not ported yet (ROADMAP.md "
             "Queue 1 item 10, core/sharding.py)")


class InfeasibleError(RuntimeError):
    """Deadlines/SLAs cannot be met with the available capacity."""


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
    mesh : object, optional
        Lane mesh; recorded in the fingerprint, but sharded solves are not
        ported yet (ROADMAP.md Queue 1 item 10) and raise.
    residency : str
        ``"round-trip"``; ``"resident"`` is not ported yet and raises.
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
    """Compare every lane against its exact centralized (P3) optimum.

    Window solves use it (ROADMAP.md Queue 1 item 9); ``atol`` is the
    absolute slack allowed when a feasible lane's GNEP total undercuts the
    exact optimum.
    """
    enabled: bool = False
    atol: float = 1e-6


@dataclass(frozen=True)
class Policies:
    """The engine's operational policy bundle (one-shot solves)."""
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


# --------------------------------------------------------------------------
# Input coercion
# --------------------------------------------------------------------------


def _coerce(problem, *, dtype=None, n_max: Optional[int] = None,
            device="cuda") -> ScenarioBatch:
    """Normalize any accepted problem form into a :class:`ScenarioBatch`
    on ``device``.

    Parameters
    ----------
    problem : ScenarioBatch, Scenario or Sequence[Scenario]
        A prepared batch, a single instance (stacked as one lane) or a
        plain — possibly ragged — scenario list (stacked/padded here).
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
            "Sequence[Scenario] or a ScenarioBatch")
    if dtype is not None:
        batch = ScenarioBatch(scenarios=_cast_floats(batch.scenarios, dtype),
                              mask=batch.mask, n_classes=batch.n_classes)
    return batch


def _cast_floats(tree, dtype):
    """Cast every floating tensor of ``tree`` to ``dtype``; integer and bool
    tensors pass through."""
    dt = _torch_dtype(dtype)
    return tree_map(lambda t: t.to(dt) if t.is_floating_point() else t, tree)


def _dtype_check(cfg: SolverConfig, batch: ScenarioBatch,
                 sol: Solution) -> Optional[dict]:
    """The ``dtype_policy="f32_checked"`` cross-check of a batched solve.

    Re-solves ``cfg.check_sample()`` evenly-spaced sample lanes in float64
    on the unfused plain path and holds each lane's relative L1 allocation
    deviation to ``2 * cfg.eps_bar`` (plus 1e-6).

    Returns
    -------
    dict or None
        ``{"lanes": [...], "max_rel": float, "bound": float}``; None when
        the policy does not check.

    Raises
    ------
    RuntimeError
        Naming the offending lanes when a sampled lane deviates too far.
    """
    k = cfg.check_sample()
    if k == 0:
        return None
    B = batch.batch_size
    k = min(k, B)
    lanes = [int(b) for b in
             np.unique(np.linspace(0, B - 1, k).round().astype(int))]

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
        if self.config.residency == "resident":
            raise NotImplementedError(_RESIDENT)
        if self.config.residency != "round-trip":
            raise ValueError(
                f"unknown residency {self.config.residency!r} — "
                "expected 'round-trip' or 'resident'")

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
    def open_window(self, *args, **kwargs):
        """Not ported yet: the runtime loop over admission windows."""
        raise NotImplementedError(_WINDOWS)


class WindowSession:
    """Not ported yet: the live admission-window loop."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_WINDOWS)
