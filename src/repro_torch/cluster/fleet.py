"""Fleet-level integration of the paper's GNEP allocator.

Counterpart of ``repro.cluster.fleet``.  Tenant classes (arch x shape cells
with SLAs) bid for the chips of a simulated cluster through the RM/CM game
exactly as the paper's job classes bid for VMs:

  * job profiles (A_i, B_i, C_i) are fitted from the dry-run roofline terms
    of each tenant's cell (compute seconds -> map wave, collective seconds
    -> reduce wave), as ``core.profiles.from_roofline`` does;
  * every allocator epoch (the paper's hourly re-solve), the distributed
    best-reply game allocates chips; Algorithm 4.2 integerizes; chips are
    factored into (data, model) sub-meshes per tenant (:meth:`mesh_plan`,
    arithmetic on the simulated grant: the card runs the allocator, not the
    tenants);
  * node failures shrink R and trigger a re-solve (the paper's Fig. 2
    decreasing-capacity experiment, run live);
  * stragglers are mitigated at the allocator level by inflating A_i with an
    over-provisioning factor (speculative-execution analog).

The games are solved on ``device`` (default the card; ``device="cpu"``
solves on the CPU).  Results are read to the host once per array, never
one element at a time.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import (CapacityChange, CapacityEngine, ClassArrival,
                              ClassDeparture, CompactionPolicy,
                              CrossCheckPolicy, FlushPolicy, Policies,
                              RAW_CLASS_FIELDS, Scenario, SLAEdit,
                              SolverConfig, derive)
from repro_torch.utils import fdtype, resolve_device


@dataclass
class TenantSpec:
    name: str
    arch_id: str
    shape: str
    deadline_s: float          # SLA: per-window completion time for one job
    H_up: int                  # max concurrent jobs (SLA)
    H_low: int                 # guaranteed minimum
    penalty_per_job: float     # m_i [cents]
    max_bid: float = 20.0      # rho_i^up
    tp_required: int = 16      # model-parallel degree the arch needs
    straggler_factor: float = 1.0


@dataclass
class Allocation:
    chips: Dict[str, int]
    h: Dict[str, int]
    meshes: Dict[str, tuple]
    total_cost: float
    method: str
    iters: int
    # epoch/epoch_batch raise InfeasibleError instead of producing an
    # infeasible Allocation, so the flag is only ever False on the streaming
    # path, where overload transients are legitimate and must be observable.
    feasible: bool = True


def _host(x: torch.Tensor) -> np.ndarray:
    """One read of a whole tensor to the host."""
    return x.detach().cpu().numpy()


class FleetSimulator:
    """Chips-for-tenants market driven by the paper's game.

    ``device`` is where the fleet's scenario is derived and its game solved
    (default the card).
    """

    def __init__(self, total_chips: int, tenants: List[TenantSpec], *,
                 chip_cost: float = 1.0, profile_dir: Optional[str] = None,
                 device="cuda"):
        self.R = total_chips
        self.tenants = tenants
        self.chip_cost = chip_cost
        self.profile_dir = profile_dir
        self.device = resolve_device(device)
        self.history: List[Allocation] = []

    # ---------------- profiles from the dry-run roofline ------------------
    def _roofline_record(self, t: TenantSpec) -> dict:
        """The tenant's cell from the port's dry run
        (``repro_torch.launch.dryrun``, by default its ``RESULTS_DIR``)."""
        if self.profile_dir is None:
            from repro_torch.launch.dryrun import RESULTS_DIR
            d = RESULTS_DIR
        else:
            d = Path(self.profile_dir)
        fn = d / f"{t.arch_id}__{t.shape}__single.json"
        rec = json.loads(fn.read_text())
        assert rec["status"] == "ok", f"no roofline for {t.name}"
        if rec["roofline"]["t_collective"] is None:
            raise ValueError(
                f"{fn}: the dry run has no collective term for {t.name} "
                "(a mesh repeats one device and no collective runs: ROADMAP "
                "item 26); give this tenant's (t_compute, t_collective, "
                "overhead) in profiles=")
        return rec

    def tenant_class_params(self, t: TenantSpec,
                            profiles: Optional[dict] = None) -> dict:
        """Raw GNEP class parameters for ONE tenant.

        The single source of the roofline -> job-profile fitting for both
        the batch path (:meth:`scenario` stacks these dicts) and the
        streaming path (a ``ClassArrival`` takes one directly): a job
        profiled at 256 chips spends ``t_compute`` seconds in math (the map
        wave, ~1/chips) and ``t_collective`` in collectives (the reduce
        wave), exactly the paper's ``A h / s`` form with c^M = c^R = 1
        slot/chip (see ``profiles.from_roofline``).
        """
        profiles = (profiles if profiles is not None
                    else getattr(self, "_profiles", None))
        if profiles and t.name in profiles:
            c, x, o = profiles[t.name]
        else:
            rf = self._roofline_record(t)["roofline"]
            c, x, o = rf["t_compute"], rf["t_collective"], 1.0
        return {
            "A": float(c * 256.0 * t.straggler_factor),
            "B": float(max(x, 1e-6) * 256.0),
            "E": float(o - t.deadline_s),
            "cM": 1.0, "cR": 1.0,
            "H_up": float(t.H_up), "H_low": float(t.H_low),
            "m": float(t.penalty_per_job), "rho_up": float(t.max_bid),
        }

    def scenario(self, *, profiles: Optional[dict] = None) -> Scenario:
        """The fleet's derived :class:`Scenario`, on the fleet's device."""
        params = [self.tenant_class_params(t, profiles=profiles)
                  for t in self.tenants]
        arrs = {k: torch.tensor([p[k] for p in params], dtype=fdtype(),
                                device=self.device)
                for k in RAW_CLASS_FIELDS}
        return derive(**arrs, R=float(self.R), rho_bar=self.chip_cost)

    # ---------------- epoch: solve the game, plan meshes -------------------
    def epoch(self, *, method: str = "distributed",
              profiles: Optional[dict] = None) -> Allocation:
        if profiles is not None:
            self._profiles = profiles
        profiles = getattr(self, "_profiles", None)
        scn = self.scenario(profiles=profiles)
        res = CapacityEngine(device=self.device).solve(scn, method=method)
        it = res.integer
        return self._allocation_from_integer(
            _host(it.r), _host(it.h), float(it.total), iters=res.iters,
            method=method)

    @staticmethod
    def mesh_plan(chips: int, tp: int) -> tuple:
        """Factor a chip grant into (data, model); unusable remainder chips
        are returned to the pool (reported)."""
        if chips < tp:
            return (1, max(1, chips))
        return (chips // tp, tp)

    # ---------------- fault tolerance --------------------------------------
    def fail_nodes(self, n_chips: int, *, method: str = "distributed"):
        """Capacity drop -> immediate re-solve (paper Sec. 5.2.1, live)."""
        self.R = max(0, self.R - n_chips)
        return self.epoch(method=method)

    def restore_nodes(self, n_chips: int, *, method: str = "distributed"):
        self.R += n_chips
        return self.epoch(method=method)

    def mark_straggler(self, tenant_name: str, factor: float = 1.3,
                       *, method: str = "distributed"):
        """Inflate a tenant's map-wave profile (speculative re-execution
        headroom) and re-solve."""
        for t in self.tenants:
            if t.name == tenant_name:
                t.straggler_factor = factor
        return self.epoch(method=method)

    def _allocation_from_integer(self, r: np.ndarray, h: np.ndarray,
                                 total: float, *, iters: int,
                                 method: str) -> Allocation:
        """Build an Allocation record from one lane's integer solution, its
        ``r`` and ``h`` already on the host (indexed per tenant, so that no
        tenant costs a device read) and trimmed to this fleet's tenants."""
        chips, hmap, meshes = {}, {}, {}
        for i, t in enumerate(self.tenants[:len(r)]):
            c = int(r[i])
            chips[t.name] = c
            hmap[t.name] = int(h[i])
            meshes[t.name] = self.mesh_plan(c, t.tp_required)
        alloc = Allocation(chips=chips, h=hmap, meshes=meshes,
                           total_cost=float(total), method=method,
                           iters=int(iters))
        self.history.append(alloc)
        return alloc


def _common_device(fleets: Sequence[FleetSimulator]) -> torch.device:
    """The one device every fleet solves on; raises if they disagree."""
    devices = {f.device for f in fleets}
    if len(devices) != 1:
        raise ValueError("fleets must share one device to be solved "
                         f"together, got {sorted(map(str, devices))}")
    return devices.pop()


def epoch_batch(fleets: Sequence[FleetSimulator], *,
                profiles: Optional[Sequence[Optional[dict]]] = None,
                eps_bar: float = 0.03, lam: float = 0.05,
                max_iters: int = 200, sweep_fn=None,
                mesh=None) -> List[Allocation]:
    """One allocator epoch for MANY fleets: every fleet's RM/CM game is a lane
    of one batched GNEP solve (ragged tenant counts pad to n_max), then one
    vectorized Algorithm 4.2 rounding pass.  This is the multi-cluster analog
    of the paper's hourly re-solve: a fleet operator runs thousands of
    clusters / what-if probes per epoch in one batched solve.

    ``profiles``: optional per-fleet profile dicts (same semantics as
    ``FleetSimulator.epoch(profiles=...)``, remembered for later epochs);
    fleets without one fall back to their stored profiles or the dry-run
    roofline files.

    ``sweep_fn``: optional batched RM sweep, e.g.
    ``kernels.gnep_sweep.ops.make_batched_sweep_fn()`` (the CUDA kernel on
    the card).

    ``mesh``: optional 1-D lane mesh (``repro_torch.core.sharding
    .lane_mesh``) — the fleets' games split into one lane slice per device;
    a fleet count that does not divide the device count is padded with
    inert lanes.  Per-fleet allocations match the unsharded epoch.

    The solve runs on the fleets' common device (``ValueError`` if they
    disagree) and raises ``InfeasibleError`` naming any infeasible fleet.
    Appends the resulting Allocation to each fleet's history and returns
    the per-fleet list, in input order.
    """
    if not fleets:
        raise ValueError("epoch_batch needs at least one fleet")
    dev = _common_device(fleets)
    if profiles is not None:
        for f, p in zip(fleets, profiles):
            if p is not None:
                f._profiles = p
    scns = [f.scenario(profiles=getattr(f, "_profiles", None)) for f in fleets]
    engine = CapacityEngine(SolverConfig(eps_bar=eps_bar, lam=lam,
                                         max_iters=max_iters,
                                         sweep_fn=sweep_fn, mesh=mesh),
                            device=dev)
    res = engine.solve(scns)
    # one device->host transfer per array for the whole batch
    r_np, h_np = _host(res.integer.r), _host(res.integer.h)
    total_np, iters_np = _host(res.integer.total), _host(res.iters)
    n_np = _host(res.n_classes)
    allocs = []
    for b, f in enumerate(fleets):
        n = int(n_np[b])
        allocs.append(f._allocation_from_integer(
            r_np[b, :n], h_np[b, :n], total_np[b], iters=iters_np[b],
            method="distributed-batch"))
    return allocs


# Fleet-level stream events: ("arrive", fleet, TenantSpec[, profile]),
# ("depart", fleet, tenant_name), ("edit", fleet, tenant_name, spec_updates),
# ("capacity", fleet, new_total_chips), ("fleet-arrive", FleetSimulator),
# ("fleet-depart", fleet).
FleetEvent = Tuple


def epoch_stream(fleets: Sequence[FleetSimulator],
                 epochs: Iterable[Sequence[FleetEvent]], *,
                 n_max: Optional[int] = None, eps_bar: float = 0.03,
                 lam: float = 0.05, max_iters: int = 200, sweep_fn=None,
                 mesh=None, cross_check: bool = False,
                 compact_below: Optional[float] = None
                 ) -> Iterator[List[Allocation]]:
    """Drive MANY fleets' games through a tenant arrival/departure trace.

    The multi-fleet analog of the paper's *runtime* loop, driven through one
    :class:`~repro_torch.core.WindowSession`: every fleet is one lane of the
    session's live window; each epoch's events (tenants arriving, leaving,
    renegotiating SLAs, capacity changes) buffer in the session and one
    ``session.flush()`` per epoch coalesces them into one window update
    plus one warm-started incremental re-solve of exactly the dirtied lanes
    — fleets with no events keep their equilibrium at zero solver cost,
    unlike :func:`epoch_batch` which re-stacks and re-solves everything.
    Whole fleets can join and leave mid-stream (the window grows/shrinks its
    lane count at the epoch boundary), and a sparse long-lived window is
    re-packed by the session's compaction policy when ``compact_below`` is
    set.

    Parameters
    ----------
    fleets : Sequence[FleetSimulator]
        One lane each, all on one device (``ValueError`` otherwise); copied
        internally, so the caller's sequence is never mutated (and
        fleet-indexed events address the *internal* order once
        ``fleet-arrive``/``fleet-depart`` reshuffle it).  The fleet objects
        themselves are shared: tenant lists and histories are kept in sync
        as events apply, and allocations append to each fleet's
        ``history``.  The yielded allocation lists follow the current
        internal fleet order.
    epochs : Iterable[Sequence[FleetEvent]]
        Outer iterable = allocator epochs (the paper's hourly re-solves);
        each element is the event list to apply before that epoch's solve:

        * ``("arrive", fleet_idx, TenantSpec)`` or
          ``("arrive", fleet_idx, TenantSpec, (t_compute, t_coll, t_over))``
          to also register the tenant's profile;
        * ``("depart", fleet_idx, tenant_name)``;
        * ``("edit", fleet_idx, tenant_name, {TenantSpec field: value})``;
        * ``("capacity", fleet_idx, new_total_chips)``;
        * ``("fleet-arrive", FleetSimulator)`` — a new cluster joins as a
          fresh window lane (its current tenants admitted wholesale);
        * ``("fleet-depart", fleet_idx)`` — a cluster leaves; its lane is
          removed and later indices shift down by one (indices always
          refer to the *current* fleet ordering).
    n_max : int, optional
        Initial padded width headroom for the window.
    eps_bar, lam, max_iters, sweep_fn
        Solver knobs of the session's ``SolverConfig``.
    mesh : repro_torch.core.sharding.LaneMesh, optional
        1-D lane mesh: the window's lanes split into one slice a device per
        solve (``SolverConfig.mesh``).
    cross_check : bool, optional
        Cross-check every epoch against the exact centralized optimum.
    compact_below : float, optional
        Occupancy threshold (-> ``CompactionPolicy.occupancy``): after an
        epoch's events apply, if the window's occupied-slot fraction drops
        below this value the session compacts the window and the
        tenant->slot maps are remapped through the report's ``slot_map``.
        None (default) never compacts.

    Yields
    ------
    list of Allocation
        Per-fleet allocations after each epoch, in current fleet order.
        Unlike :func:`epoch_batch`, no ``InfeasibleError`` is raised: an
        overloaded fleet (arrival burst, capacity loss) is a legitimate
        transient here, flagged on ``Allocation.feasible`` — its chips/h
        are the over-capacity projection and must not be deployed.
    """
    fleets = list(fleets)
    dev = _common_device(fleets)
    scns = [f.scenario(profiles=getattr(f, "_profiles", None)) for f in fleets]
    engine = CapacityEngine(
        SolverConfig(eps_bar=eps_bar, lam=lam, max_iters=max_iters,
                     sweep_fn=sweep_fn, mesh=mesh),
        Policies(flush=FlushPolicy(max_events=None),   # one flush per epoch
                 compaction=CompactionPolicy(occupancy=compact_below),
                 cross_check=CrossCheckPolicy(cross_check)),
        device=dev)
    session = engine.open_window(scns, n_max=n_max)
    # tenant name -> window slot, per lane (initial stack order is 0..n-1)
    slots: List[Dict[str, int]] = [
        {t.name: i for i, t in enumerate(f.tenants)} for f in fleets]
    # class events buffer in the session; arrivals' slots resolve at drain
    pending_arrivals: List[Tuple[int, str]] = []

    def flush_pending() -> None:
        if not session.pending:
            return
        granted = session.drain()
        for slot, (b, name) in zip((s for s in granted if s is not None),
                                   pending_arrivals):
            slots[b][name] = slot
        pending_arrivals.clear()

    def slot_of(b: int, name: str) -> int:
        # a tenant that arrived earlier in this same epoch has no slot yet
        if any(pb == b and pn == name for pb, pn in pending_arrivals):
            flush_pending()
        return slots[b][name]

    def apply_event(ev: FleetEvent) -> None:
        kind = ev[0]
        if kind == "fleet-arrive":
            f = ev[1]
            if f.device != dev:
                raise ValueError(f"arriving fleet on {f.device}, the "
                                 f"stream's fleets on {dev}")
            flush_pending()                      # lane ops at flush boundaries
            b = session.add_lane(
                f.scenario(profiles=getattr(f, "_profiles", None)))
            fleets.append(f)
            slots.append({t.name: i for i, t in enumerate(f.tenants)})
            assert b == len(fleets) - 1
            return
        if kind == "fleet-depart":
            b = int(ev[1])
            flush_pending()
            session.remove_lane(b)
            del fleets[b]
            del slots[b]
            return
        b = int(ev[1])
        f = fleets[b]
        if kind == "arrive":
            spec = ev[2]
            if (spec.name in slots[b]
                    or any(pb == b and pn == spec.name
                           for pb, pn in pending_arrivals)):
                raise ValueError(
                    f"fleet {b} already has a tenant named {spec.name!r}")
            if len(ev) > 3 and ev[3] is not None:
                profs = dict(getattr(f, "_profiles", None) or {})
                profs[spec.name] = tuple(ev[3])
                f._profiles = profs
            f.tenants.append(spec)
            session.apply(ClassArrival(lane=b,
                                       params=f.tenant_class_params(spec)))
            pending_arrivals.append((b, spec.name))
        elif kind == "depart":
            name = ev[2]
            session.apply(ClassDeparture(lane=b, slot=slot_of(b, name)))
            del slots[b][name]
            f.tenants[:] = [t for t in f.tenants if t.name != name]
        elif kind == "edit":
            name, updates = ev[2], dict(ev[3])
            (spec,) = [t for t in f.tenants if t.name == name]
            for k, v in updates.items():
                setattr(spec, k, v)
            session.apply(SLAEdit(lane=b, slot=slot_of(b, name),
                                  updates=f.tenant_class_params(spec)))
        elif kind == "capacity":
            f.R = int(ev[2])
            session.apply(CapacityChange(lane=b, R=float(f.R)))
        else:
            raise ValueError(f"unknown fleet event kind {kind!r}")

    for events in epochs:
        for ev in events:
            apply_event(ev)
        flush_pending()
        res = session.flush()                    # policy compaction + solve
        if res.slot_map is not None:             # window was re-packed
            for b in range(len(slots)):
                slots[b] = {name: int(res.slot_map[b, s])
                            for name, s in slots[b].items()}
        # one device->host transfer per array, not per tenant
        r_np, h_np = _host(res.integer.r), _host(res.integer.h)
        total_np, iters_np = _host(res.integer.total), _host(res.iters)
        feas_np = _host(res.feasible)
        allocs = []
        for b, f in enumerate(fleets):
            chips = {n: int(r_np[b, s]) for n, s in slots[b].items()}
            hmap = {n: int(h_np[b, s]) for n, s in slots[b].items()}
            meshes = {t.name: f.mesh_plan(chips[t.name], t.tp_required)
                      for t in f.tenants}
            alloc = Allocation(chips=chips, h=hmap, meshes=meshes,
                               total_cost=float(total_np[b]),
                               method="streaming",
                               iters=int(iters_np[b]),
                               feasible=bool(feas_np[b]))
            f.history.append(alloc)
            allocs.append(alloc)
        yield allocs
