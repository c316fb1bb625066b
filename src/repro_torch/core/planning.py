"""Fleet-scale capacity planner: design-space exploration over what-if batches.

Counterpart of ``repro.core.planning``.  The paper's allocator answers "how
many chips does each class get *right now*"; this module runs the
design-tool loop of D-SPACE4Cloud (PAPERS.md) on top of it — a sweep over
cluster size / VM tier / deadline tightness / penalty scaling that returns
the cheapest feasible design:

* :class:`PlanSpec` declares the fleet design space (axes) plus the workload
  it is sized for — one of the shared trace profiles of
  :mod:`repro_torch.core.traces`;
* :func:`generate_grid` expands the spec into a deterministic, seeded list
  of :class:`Candidate` design points, each carrying a fully derived
  :class:`~repro_torch.core.types.Scenario` (the deadline axis is the
  innermost grid dimension, so adjacent candidates differ only in deadline
  tightness).  Class parameters come from a ``torch.Generator`` per class,
  so a grid matches the reference's in distribution, not bit for bit;
* :func:`solve_plan` packs candidates into fixed-width, inert-lane-padded
  :class:`~repro_torch.core.types.ScenarioBatch` chunks and pushes them
  through :class:`~repro_torch.core.engine.CapacityEngine`'s batch path
  (lane-sharded when the config carries a mesh).  Lanes are independent,
  padding is solver-inert and the loop's row sums do not depend on a row's
  place (``game._aligned_classes``), so the chunked results are bit for bit
  one direct solve over all candidates.  An opt-in warm-start mode seeds
  each deadline step's allocation from the previous step's equilibrium
  (bids restart cold, so the Alg. 4.1 iterate trajectory is preserved and
  only the stopping time can differ);
* :class:`PlanReport` reduces the per-candidate solutions into the paper's
  objective decomposition (power cost vs rejection penalty, per-lane
  feasibility = "deadline attainable under this design"), with Pareto
  frontier extraction and a cheapest-feasible-design query.

CLI: ``python -m repro_torch.launch.plan``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import game, sharding
from repro_torch.core.engine import (CapacityEngine, Policies, RoundingPolicy,
                                     SolverConfig, _cast_floats)
from repro_torch.core.profiles import sample_class_params
from repro_torch.core.traces import ARRIVAL_PROFILES
from repro_torch.core.types import (Scenario, ScenarioBatch, derive,
                                    stack_scenarios)
from repro_torch.utils import fdtype, resolve_device


@dataclass(frozen=True)
class VMTier:
    """One VM/chip SKU the planner may build the cluster from.

    Attributes
    ----------
    name : str
        SKU label (appears in candidate coordinates and reports).
    slots : float
        Slot multiplier over the workload's per-VM baseline: candidate
        scenarios scale their per-class ``cM`` / ``cR`` by it.
    price : float
        Unit-time cost of one VM of this tier [cents] — the candidate's
        ``rho_bar``.
    """
    name: str
    slots: float
    price: float


@dataclass(frozen=True)
class PlanSpec:
    """A fleet design space plus the workload it is sized for.

    The four axes (``cluster_sizes`` x ``vm_tiers`` x ``penalty_scales`` x
    ``deadline_scales``) expand into the product of their lengths;
    :func:`generate_grid` orders them with the deadline axis innermost.
    The workload half (``profile`` / ``rate`` / ``trace_events`` /
    ``n_classes``) shapes the per-class demand mix: the sizing trace is
    histogrammed into ``n_classes`` equal time windows and each window's
    load modulates its class's SLA concurrency.

    Attributes
    ----------
    n_classes : int
        Job classes per candidate scenario.
    profile : str
        Workload-trace profile name (an :data:`ARRIVAL_PROFILES` key).
    rate : float
        Mean arrival rate [events/s] of the sizing trace.
    trace_events : int
        Events in the sizing trace.
    cluster_sizes : tuple of float
        Candidate cluster capacities R.
    vm_tiers : tuple of VMTier
        Candidate VM SKUs.
    deadline_scales : tuple of float
        Deadline-tightness multipliers on D_i (the innermost grid axis).
    penalty_scales : tuple of float
        Multipliers on the per-class rejection penalty ``m``.
    seed : int
        Seed of the class-parameter draws and the sizing trace; the grid is
        a function of the spec.
    """
    n_classes: int = 4
    profile: str = "poisson"
    rate: float = 50.0
    trace_events: int = 512
    cluster_sizes: Tuple[float, ...] = (1500.0, 3000.0, 6000.0)
    vm_tiers: Tuple[VMTier, ...] = (VMTier("small", 1.0, 6.0),
                                    VMTier("large", 2.0, 10.0))
    deadline_scales: Tuple[float, ...] = (0.8, 1.0, 1.2)
    penalty_scales: Tuple[float, ...] = (1.0,)
    seed: int = 0

    @property
    def grid_shape(self) -> Tuple[int, int, int, int]:
        """Axis lengths in grid order: (clusters, tiers, penalties,
        deadlines)."""
        return (len(self.cluster_sizes), len(self.vm_tiers),
                len(self.penalty_scales), len(self.deadline_scales))

    @property
    def n_candidates(self) -> int:
        """Total design points the spec expands into."""
        n = 1
        for axis in self.grid_shape:
            n *= axis
        return n


@dataclass(frozen=True)
class Candidate:
    """One design point of an expanded :class:`PlanSpec` grid.

    Attributes
    ----------
    index : int
        Position in the grid's candidate order (deadline axis innermost).
    coords : dict
        ``cluster_size``, ``tier`` (name), ``penalty_scale``,
        ``deadline_scale``.
    scenario : Scenario
        The fully derived allocation instance for this design point.
    """
    index: int
    coords: Dict[str, object]
    scenario: Scenario


def _trace_weights(spec: PlanSpec) -> np.ndarray:
    """Per-class demand weights from the spec's sizing trace: each of
    ``n_classes`` equal time windows' share of the events, normalized to
    mean 1 and floored at 0.25."""
    times = ARRIVAL_PROFILES[spec.profile](spec.seed, spec.trace_events,
                                           spec.rate)
    edges = np.linspace(0.0, float(times[-1]), spec.n_classes + 1)
    counts, _ = np.histogram(np.asarray(times), bins=edges)
    mean = max(float(counts.mean()), 1e-12)
    return np.maximum(counts / mean, 0.25)


def class_generator(seed: int, index: int) -> torch.Generator:
    """The CPU ``torch.Generator`` of one (seed, index) pair: the port's
    stand-in for ``jax.random.fold_in(PRNGKey(seed), index)``."""
    state = np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def generate_grid(spec: PlanSpec, *, device="cuda") -> List[Candidate]:
    """Expand ``spec`` into its deterministic candidate list on ``device``.

    Class ``i``'s parameters are drawn from :func:`class_generator`
    ``(spec.seed, i)``, afresh at every deadline scale, so candidates that
    differ only in ``deadline_scale`` share every draw and differ only
    through the scaled deadline.  The sizing trace's demand weights
    modulate each class's ``H_up`` (with ``H_low = max(floor(0.8 *
    H_up), 1)``); the tier scales ``cM`` / ``cR`` by its slots and prices
    ``rho_bar``; the penalty scale multiplies ``m``.

    Candidate order: ``cluster_sizes`` (outermost) x ``vm_tiers`` x
    ``penalty_scales`` x ``deadline_scales`` (innermost), so
    ``index = (((ci * T) + ti) * P + pi) * D + di``.

    Raises
    ------
    ValueError
        Unknown ``spec.profile``, or non-positive ``n_classes`` /
        ``trace_events``.
    """
    if spec.profile not in ARRIVAL_PROFILES:
        raise ValueError(f"unknown profile {spec.profile!r} — expected one "
                         f"of {sorted(ARRIVAL_PROFILES)}")
    if spec.n_classes < 1:
        raise ValueError(f"n_classes={spec.n_classes} must be >= 1")
    if spec.trace_events < 1:
        raise ValueError(f"trace_events={spec.trace_events} must be >= 1")
    dev = resolve_device(device)
    if spec.n_candidates == 0:
        return []

    dt = fdtype()
    w = _trace_weights(spec)
    base = {
        d: [sample_class_params(class_generator(spec.seed, i),
                                deadline_scale=float(d))
            for i in range(spec.n_classes)]
        for d in spec.deadline_scales
    }

    def col(values):
        return torch.tensor(values, dtype=dt, device=dev)

    candidates: List[Candidate] = []
    idx = 0
    for R in spec.cluster_sizes:
        for tier in spec.vm_tiers:
            for pen in spec.penalty_scales:
                for d in spec.deadline_scales:
                    cols = base[d]
                    H_up = np.asarray(
                        [max(round(p["H_up"] * w[i]), 1.0)
                         for i, p in enumerate(cols)], np.float64)
                    H_low = np.maximum(np.floor(0.8 * H_up), 1.0)
                    scn = derive(
                        A=col([p["A"] for p in cols]),
                        B=col([p["B"] for p in cols]),
                        E=col([p["E"] for p in cols]),
                        cM=col([p["cM"] * tier.slots for p in cols]),
                        cR=col([p["cR"] * tier.slots for p in cols]),
                        H_up=col(H_up), H_low=col(H_low),
                        m=col([p["m"] * pen for p in cols]),
                        rho_up=col([p["rho_up"] for p in cols]),
                        R=float(R), rho_bar=float(tier.price))
                    coords = {"cluster_size": float(R), "tier": tier.name,
                              "penalty_scale": float(pen),
                              "deadline_scale": float(d)}
                    candidates.append(Candidate(idx, coords, scn))
                    idx += 1
    return candidates


@dataclass
class PlanReport:
    """Per-candidate solutions of a plan solve, plus frontier queries.

    Every array is host-side numpy with one row per candidate, in grid
    order.  ``cost`` / ``penalty`` / ``total`` are the paper's objective
    decomposition; ``feasible`` is the per-design deadline-attainability
    flag (an infeasible design point is a probe result, not an error).

    Attributes
    ----------
    candidates : list of Candidate
        The solved design points (grid order).
    cost, penalty, total : numpy.ndarray
        (B,) power cost, rejection penalty and their sum per candidate.
    r : numpy.ndarray
        (B, n_max) equilibrium chip allocation per candidate.
    iters : numpy.ndarray
        (B,) Algorithm 4.1 iterations per candidate.
    feasible : numpy.ndarray
        (B,) bool deadline-attainability per candidate.
    config : SolverConfig
        The solver config the plan ran under.
    chunk : int
        Lane width candidates were packed into.
    n_chunks : int
        Solve dispatches the plan took.
    warm_start : bool
        Whether the deadline-axis warm-start mode ran.
    elapsed_s : float
        Host wall-clock of the whole plan solve.
    """
    candidates: List[Candidate]
    cost: np.ndarray
    penalty: np.ndarray
    total: np.ndarray
    r: np.ndarray
    iters: np.ndarray
    feasible: np.ndarray
    config: SolverConfig
    chunk: int
    n_chunks: int
    warm_start: bool
    elapsed_s: float = 0.0

    @property
    def n_candidates(self) -> int:
        """Number of solved design points."""
        return len(self.candidates)

    def pareto_frontier(self) -> np.ndarray:
        """Indices of the feasible (cost, penalty) Pareto frontier, sorted by
        increasing cost (strictly decreasing penalty); of exact duplicates
        only the lowest index survives.  Empty when nothing is feasible."""
        feas = np.flatnonzero(self.feasible)
        if feas.size == 0:
            return np.empty(0, dtype=int)
        order = feas[np.lexsort((feas, self.penalty[feas], self.cost[feas]))]
        front: List[int] = []
        best_pen = np.inf
        for i in order:
            if self.penalty[i] < best_pen:
                front.append(int(i))
                best_pen = self.penalty[i]
        return np.asarray(front, dtype=int)

    def cheapest_feasible(self, max_penalty: Optional[float] = None
                          ) -> Optional[int]:
        """Index of the minimum-cost feasible candidate (ties: lower
        penalty, then lower index), also within ``max_penalty`` when given;
        ``None`` when nothing qualifies."""
        ok = self.feasible.astype(bool).copy()
        if max_penalty is not None:
            ok &= self.penalty <= max_penalty
        idx = np.flatnonzero(ok)
        if idx.size == 0:
            return None
        order = np.lexsort((idx, self.penalty[idx], self.cost[idx]))
        return int(idx[order[0]])

    def point(self, i: int) -> Dict[str, object]:
        """One candidate's coordinates + solved metrics as a flat dict."""
        return {"index": int(i), **self.candidates[i].coords,
                "cost": float(self.cost[i]),
                "penalty": float(self.penalty[i]),
                "total": float(self.total[i]),
                "feasible": bool(self.feasible[i]),
                "iters": int(self.iters[i])}

    def to_json(self) -> Dict[str, object]:
        """JSON-serializable summary (the ``--json`` payload of the CLI),
        with the reference's keys."""
        cheapest = self.cheapest_feasible()
        return {
            "n_candidates": self.n_candidates,
            "n_feasible": int(np.count_nonzero(self.feasible)),
            "chunk": self.chunk, "n_chunks": self.n_chunks,
            "warm_start": self.warm_start,
            "elapsed_s": self.elapsed_s,
            "solver_config": self.config.fingerprint(),
            "frontier": [self.point(i) for i in self.pareto_frontier()],
            "cheapest_feasible": (None if cheapest is None
                                  else self.point(cheapest)),
        }


def _empty_report(cfg: SolverConfig, chunk: int,
                  warm_start: bool) -> PlanReport:
    """The zero-candidate :class:`PlanReport` (empty design space)."""
    z = np.empty(0)
    return PlanReport(candidates=[], cost=z, penalty=z, total=z,
                      r=np.empty((0, 0)), iters=np.empty(0, dtype=int),
                      feasible=np.empty(0, dtype=bool), config=cfg,
                      chunk=chunk, n_chunks=0, warm_start=warm_start)


def _chunk_targets(chunk: int, cfg: SolverConfig) -> int:
    """Padded lane width of every solve dispatch: ``chunk``, rounded up to
    the mesh's lane multiple when the config shards."""
    if cfg.mesh is None:
        return chunk
    return sharding.padded_lane_count(chunk, cfg.mesh.devices.size)


#: The per-candidate fields a plan reads back from each chunk's solve.
_FIELDS = ("cost", "penalty", "total", "r", "iters", "feasible")


def _read_back(sol, iters, feasible, real: int, n_max: int) -> dict:
    """A chunk's six result fields for its ``real`` lanes, read back to the
    host in ONE device-to-host copy: the float fields packed into one
    tensor of ``sol.r``'s dtype beside the iteration counts and flags
    (both exact in f32 and f64)."""
    r = sol.r[:real]
    packed = torch.cat([
        torch.stack([sol.cost[:real], sol.penalty[:real], sol.total[:real],
                     iters[:real].to(r.dtype), feasible[:real].to(r.dtype)],
                    dim=1), r], dim=1).cpu().numpy()
    return {"cost": packed[:, 0], "penalty": packed[:, 1],
            "total": packed[:, 2],
            "iters": packed[:, 3].astype(np.int32),
            "feasible": packed[:, 4].astype(bool),
            "r": packed[:, 5:5 + n_max]}


def _solve_cold(candidates: Sequence[Candidate], cfg: SolverConfig,
                chunk: int, n_max: int, device):
    """Chunked cold solves through the engine's batched path.

    Every chunk is inert-lane padded to the same fixed width; results are
    trimmed back to real lanes.  Bit for bit one ``CapacityEngine.solve``
    over all candidates.  Returns ``(fields, n_chunks)``.
    """
    engine = CapacityEngine(cfg, Policies(rounding=RoundingPolicy(False)),
                            device=device)
    target = _chunk_targets(chunk, cfg)
    out = {k: [] for k in _FIELDS}
    n_chunks = 0
    for start in range(0, len(candidates), chunk):
        part = candidates[start:start + chunk]
        batch = stack_scenarios([c.scenario for c in part], n_max=n_max,
                                device=engine.device)
        real = batch.batch_size
        batch = sharding.pad_batch_lanes(batch, target)
        report = engine.solve(batch, check_feasible=False)
        got = _read_back(report.fractional, report.iters, report.feasible,
                         real, n_max)
        for k in _FIELDS:
            out[k].append(got[k])
        n_chunks += 1
    return {k: np.concatenate(v) for k, v in out.items()}, n_chunks


def _solve_warm(spec: PlanSpec, candidates: Sequence[Candidate],
                cfg: SolverConfig, chunk: int, n_max: int, device):
    """Deadline-axis warm-started solves (opt-in ``solve_plan`` mode).

    The candidates factor into ``B / D`` deadline-sweep chains of length
    ``D``, chunked into fixed lane sets; each chain solves its first
    deadline step cold, then seeds every later step's allocation from the
    previous step's equilibrium with bids restarted at ``rho_bar``, which
    keeps the Alg. 4.1 iterate trajectory: results equal the cold solve bit
    for bit whenever both stop at the same iteration.  Returns
    ``(fields, n_chunks)``.
    """
    D = len(spec.deadline_scales)
    B = len(candidates)
    cross = B // D
    target = _chunk_targets(chunk, cfg)
    dt = cfg.effective_dtype()
    dev = resolve_device(device)

    fields = {
        "cost": np.empty(B), "penalty": np.empty(B), "total": np.empty(B),
        "r": np.empty((B, n_max)), "iters": np.empty(B, dtype=np.int32),
        "feasible": np.empty(B, dtype=bool),
    }
    n_chunks = 0
    for c0 in range(0, cross, chunk):
        chains = range(c0, min(c0 + chunk, cross))
        prev_r = None
        for d in range(D):
            part = [candidates[ci * D + d] for ci in chains]
            batch = stack_scenarios([c.scenario for c in part], n_max=n_max,
                                    device=dev)
            real = batch.batch_size
            batch = sharding.pad_batch_lanes(batch, target)
            if dt is not None:
                batch = ScenarioBatch(
                    scenarios=_cast_floats(batch.scenarios, dt),
                    mask=batch.mask, n_classes=batch.n_classes)
            init = game.cold_start(batch)
            if prev_r is not None:
                init = init._replace(
                    r=torch.where(batch.mask, prev_r, init.r))
            sol = game.solve_distributed_batch(
                batch, eps_bar=cfg.eps_bar, lam=cfg.lam,
                max_iters=cfg.max_iters, sweep_fn=cfg.sweep_fn, init=init,
                mesh=cfg.mesh, iter_fn=cfg.iter_fn)
            prev_r = sol.r
            rows = [c.index for c in part]
            got = _read_back(sol, sol.iters, sol.feasible, real, n_max)
            for k in _FIELDS:
                fields[k][rows] = got[k]
            n_chunks += 1
    return fields, n_chunks


def solve_plan(plan: Union[PlanSpec, Sequence[Candidate]], *,
               config: Optional[SolverConfig] = None, chunk: int = 64,
               warm_start: bool = False, device="cuda") -> PlanReport:
    """Solve every design point of a plan and reduce to a frontier report.

    Candidates are packed into fixed-width inert-lane-padded chunks and
    solved on the engine's batched Algorithm 4.1 path on ``device``,
    lane-sharded over ``config.mesh`` when set.  Rounding is off (planning
    compares fractional equilibria) and infeasible candidates are reported
    through their ``feasible`` flag, not raised.

    Parameters
    ----------
    plan : PlanSpec or sequence of Candidate
        A spec (expanded here with :func:`generate_grid` on ``device``) or
        an already-expanded candidate list (moved to ``device``).
    config : SolverConfig, optional
        Solver knobs / kernel / mesh (default: the paper's).
    chunk : int, optional
        Real candidates per solve dispatch (rounded up to the mesh's lane
        multiple when sharded).  Results are independent of ``chunk`` bit
        for bit.
    warm_start : bool, optional
        Seed each deadline step's allocation from the previous step's
        equilibrium; needs a :class:`PlanSpec`.  Per-candidate results
        equal the cold solve bit for bit whenever both stop at the same
        iteration.
    device : str or torch.device, optional
        Where the chunks are solved (default the card).

    Raises
    ------
    ValueError
        ``chunk < 1``, or ``warm_start=True`` with a plain candidate list.
    """
    cfg = config if config is not None else SolverConfig()
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    if isinstance(plan, PlanSpec):
        spec: Optional[PlanSpec] = plan
        candidates = generate_grid(plan, device=device)
    else:
        spec = None
        candidates = list(plan)
    if warm_start and spec is None:
        raise ValueError(
            "warm_start=True needs a PlanSpec (the deadline-axis chain "
            "structure comes from its axes) — pass the spec, not the "
            "expanded candidate list")
    t0 = time.perf_counter()
    if not candidates:
        return _empty_report(cfg, chunk, warm_start)
    n_max = max(c.scenario.n for c in candidates)
    if warm_start:
        fields, n_chunks = _solve_warm(spec, candidates, cfg, chunk, n_max,
                                       device)
    else:
        fields, n_chunks = _solve_cold(candidates, cfg, chunk, n_max, device)
    return PlanReport(candidates=list(candidates), config=cfg, chunk=chunk,
                      n_chunks=n_chunks, warm_start=warm_start,
                      elapsed_s=time.perf_counter() - t0, **fields)
