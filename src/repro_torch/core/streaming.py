"""Streaming admission — the paper's *runtime* allocation loop, in PyTorch.

Counterpart of ``repro.core.streaming``.  The Resource Manager and the
Class Managers re-negotiate capacity as job classes arrive and leave:

* :class:`AdmissionWindow` keeps a *live* padded :class:`ScenarioBatch`
  under :class:`~repro_torch.core.types.ClassArrival` /
  :class:`~repro_torch.core.types.ClassDeparture` /
  :class:`~repro_torch.core.types.SLAEdit` /
  :class:`~repro_torch.core.types.CapacityChange` events.  A departing
  class's slot is refilled with solver-inert neutral values and recycled by
  the next arrival; every leaf is repadded to a larger ``n_max`` only when a
  lane's row is full.
* :meth:`AdmissionWindow.warm_start` builds the incremental re-solve init:
  clean, solved lanes are *frozen* at their stored equilibrium and only
  dirty lanes iterate, from the cold Algorithm 4.1 init, so the warm solve
  is the cold re-solve of the final window while doing only the dirty
  lanes' work.
* :meth:`AdmissionWindow.apply_epoch` folds any number of events into one
  atomic update; :class:`EventEpoch` + :class:`FlushPolicy` decide when to
  re-solve; lanes are added and removed between solves, and
  :meth:`AdmissionWindow.compact` re-packs a sparse window, remapping the
  stored equilibrium so frozen lanes stay frozen.
* :meth:`AdmissionWindow.make_resident` keeps the window's tensors, a
  device mirror of its mask and its stored equilibrium at the lane count
  padded to a :class:`~repro_torch.core.sharding.LaneMesh`'s multiple, so
  a resident flush (:meth:`AdmissionWindow.resident_batch`,
  :meth:`AdmissionWindow.resident_warm_start`) solves the padded tensors
  as they are and uploads only the dirty flags.

The window's tensors live on the device of the scenarios it is built from.
The occupancy mask, the dirty flags, the raw parameters of every admitted
class and the lanes' ``rho_bar`` stay on the host, and values reach the
device through asynchronous copies, so applying an event never waits for
the card.  Every update of a device tensor is out of place (``index_put``,
``cat``), so a batch or state taken from the window earlier never changes.

The user-facing layer is :class:`repro_torch.core.engine.CapacityEngine` /
:class:`repro_torch.core.engine.WindowSession`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core import game, sharding
from repro_torch.core.profiles import sample_class_params
from repro_torch.core.types import (RAW_CLASS_FIELDS, CapacityChange,
                                    ClassArrival, ClassDeparture, Scenario,
                                    ScenarioBatch, SLAEdit, StreamEvent,
                                    WindowState, derive, neutral_class_values,
                                    pad_scenario, stack_scenarios)
from repro_torch.utils import tree_map

#: Per-class Scenario fields (raw + derived) written on every class write.
_CLASS_FIELDS = tuple(neutral_class_values(0.0).keys())
_RHO_UP = _CLASS_FIELDS.index("rho_up")


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dt).numpy().dtype


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of host ``arr`` on ``dev`` that never waits for the card.

    On CUDA the copy goes through a pinned staging buffer asynchronously on
    the current stream (PyTorch's caching host allocator keeps the buffer
    until the copy is done); on the CPU it is a plain copy.  Either way the
    tensor shares no memory with ``arr``, which later events rewrite.
    """
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


def _derive_classes(params_list: Sequence[dict], dtype: torch.dtype,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Derived constants (Props. 3.3, Eqs. 7/8/17/18) of many classes.

    :func:`~repro_torch.core.types.derive` on ``device``, the window's, in
    the window's dtype: the same function on the same device that
    ``stack_scenarios`` runs, so an admitted class's constants are bit for
    bit those of a batch stacked afresh from its raw parameters.  (Deriving
    on the host would not do for a window on the card: the CPU build's f64
    ``sqrt`` is not correctly rounded everywhere, the card's is.)

    Returns
    -------
    dict
        Field name -> (T,) tensor on ``device`` for every per-class field
        of :class:`Scenario`, aligned with ``params_list``.
    """
    for params in params_list:
        missing = set(RAW_CLASS_FIELDS) - set(params)
        if missing:
            raise ValueError(f"class params missing fields {sorted(missing)}")
    raw = _to_device(np.asarray([[float(p[k]) for p in params_list]
                                 for k in RAW_CLASS_FIELDS], _np_dtype(dtype)),
                     device)
    zero = torch.zeros((), dtype=dtype, device=device)
    many = derive(**dict(zip(RAW_CLASS_FIELDS, raw)), R=zero, rho_bar=zero)
    return {f: getattr(many, f) for f in _CLASS_FIELDS}


class AdmissionWindow:
    """A live, padded :class:`ScenarioBatch` plus last-equilibrium state.

    Each *lane* is one running allocation game (one cluster); events admit,
    remove or renegotiate job classes inside a lane.  The window keeps

    * the stacked :class:`Scenario` tensors ((B, n_max) per class, (B,)
      scalars) on its device, vacated and never-used slots held at
      solver-inert neutral values;
    * the occupancy mask, on the host;
    * the previous equilibrium (:class:`~repro_torch.core.types.WindowState`)
      and a per-lane host *dirty* flag driving the warm-started re-solve.

    Parameters
    ----------
    scenarios : Sequence[Scenario]
        Initial (possibly ragged) instances, one per lane, all on one
        device; the window lives there.
    n_max : int, optional
        Initial padded width (default: the largest class count); headroom
        avoids early growth.
    growth_factor : float, optional
        When a lane's row is full, every leaf is repadded to
        :func:`grown_n_max` columns.

    Notes
    -----
    Feasibility is not enforced at admission: a burst of arrivals may push
    ``sum(r_low) > R`` until load is shed, and the solve reports per-lane
    ``feasible`` flags.
    """

    def __init__(self, scenarios: Sequence[Scenario], *,
                 n_max: Optional[int] = None, growth_factor: float = 2.0):
        scns = list(scenarios)
        if not scns:
            raise ValueError("AdmissionWindow needs at least one lane")
        if growth_factor <= 1.0:
            raise ValueError("growth_factor must be > 1")
        devices = {s.A.device for s in scns}
        if len(devices) > 1:
            raise ValueError("the scenarios lie on more than one device: "
                             f"{sorted(map(str, devices))}")
        self.device = devices.pop()
        batch = stack_scenarios(scns, n_max=n_max, device=self.device)
        self._scn = batch.scenarios
        self._mask = batch.mask.cpu().numpy().copy()
        # host copy of each lane's unit chip cost: vacated slots take it as
        # their neutral bid, and reading it off the card would wait for it
        self._rho_bar_host = self._scn.rho_bar.double().cpu().numpy().copy()
        self.growth_factor = float(growth_factor)
        self.dirty = np.zeros(self.batch_size, bool)
        # per-lane memo of the exact centralized (P3) total, invalidated by
        # the same events that dirty a lane
        self.baseline_totals = np.full(self.batch_size, np.nan)
        self.baseline_stale = np.ones(self.batch_size, bool)
        self._state: Optional[WindowState] = None
        # the resident layout (make_resident): the mesh, the (padded B,
        # n_max) device mask mirror and the cached class counts
        self._resident_mesh: Optional[sharding.LaneMesh] = None
        self._mask_dev: Optional[torch.Tensor] = None
        self._n_classes_dev: Optional[torch.Tensor] = None
        self._n_classes_host: Optional[np.ndarray] = None
        # raw per-class parameters, so SLA edits can merge partial updates
        cols = {f: getattr(self._scn, f).cpu().numpy()
                for f in RAW_CLASS_FIELDS}
        self._raw: Dict[Tuple[int, int], dict] = {
            (b, i): {f: float(cols[f][b, i]) for f in RAW_CLASS_FIELDS}
            for b, s in enumerate(scns) for i in range(s.n)}

    # ------------------------------------------------------------------ views
    @property
    def batch_size(self) -> int:
        return self._mask.shape[0]

    @property
    def n_max(self) -> int:
        return self._mask.shape[1]

    @property
    def n_classes(self) -> np.ndarray:
        """(B,) host array — current number of admitted classes per lane."""
        return self._mask.sum(axis=1)

    @property
    def batch(self) -> ScenarioBatch:
        """The current window as a solver-ready :class:`ScenarioBatch`.

        Its mask is a copy of the host mask: on the CPU a tensor made with
        ``torch.from_numpy`` would share ``_mask``'s memory, and a report
        holding it would follow later events.  A resident window's padding
        lanes are left out (row views of its tensors).
        """
        scn, b = self._scn, self.batch_size
        if scn.A.shape[0] > b:
            scn = tree_map(lambda leaf: leaf[:b], scn)
        return ScenarioBatch(
            scenarios=scn, mask=_to_device(self._mask, self.device),
            n_classes=_to_device(self.n_classes.astype(np.int64),
                                 self.device))

    @property
    def state(self) -> Optional[WindowState]:
        """Last committed equilibrium, or None before the first solve."""
        return self._state

    @property
    def occupancy(self) -> float:
        """Fraction of the (B, n_max) slot grid holding an admitted class
        (the compaction signal)."""
        return float(self._mask.mean()) if self._mask.size else 0.0

    def occupied(self, lane: int) -> List[int]:
        """Slot indices currently holding an admitted class in ``lane``."""
        return [int(i) for i in np.flatnonzero(self._mask[lane])]

    # -------------------------------------------------------- device residency
    @property
    def is_resident(self) -> bool:
        """Whether the window's tensors are kept padded on a lane mesh."""
        return self._resident_mesh is not None

    @property
    def resident_mesh(self) -> Optional[sharding.LaneMesh]:
        """The 1-D lane mesh the window is resident on (None when not)."""
        return self._resident_mesh

    def make_resident(self, mesh: sharding.LaneMesh) -> None:
        """Keep the window's device state padded on ``mesh``, to stay.

        The scenario tensors, a device mirror of the occupancy mask and the
        stored equilibrium are padded with inert lanes
        (``sharding.pad_batch_lanes``) to the mesh's device multiple; every
        later event updates the padded tensors (out of place), and
        :meth:`grow` re-places them.  Lane geometry changes (:meth:`add_lane`,
        :meth:`remove_lane`, :meth:`compact`) run at the logical lane count
        and re-establish residency before they return.  The host mask and
        raw parameters stay authoritative.

        Parameters
        ----------
        mesh : repro_torch.core.sharding.LaneMesh
            1-D lane mesh whose first device is the window's.  Calling again
            with another mesh migrates the window.

        Raises
        ------
        ValueError
            For a mesh that is not 1-D or that starts on another device than
            the window's (a window never moves to a mesh elsewhere).
        """
        sharding.lane_sharding(mesh)                 # refuses a mesh not 1-D
        if mesh.devices[0] != self.device:
            raise ValueError(
                f"the window lies on {self.device}, the mesh starts on "
                f"{mesh.devices[0]}: a resident mesh starts on the window's "
                "device")
        if self._resident_mesh is not None and self._resident_mesh != mesh:
            self._exit_residency()
        self._resident_mesh = mesh
        self._place_device_leaves()

    def release_resident(self) -> None:
        """Return to the round-trip layout: trim the padding lanes off every
        tensor and drop the device mask mirror.  The window is then equal,
        leaf by leaf, to one that was never resident."""
        if self._resident_mesh is not None:
            self._exit_residency()

    def resident_batch(self) -> ScenarioBatch:
        """The resident (lane-padded) solver view of the window.

        Scenarios and mask are the live padded tensors; the (padded B,)
        class counts are uploaded again only when occupancy changed.

        Raises
        ------
        RuntimeError
            When the window is not resident.
        """
        self._check_resident()
        pad_b = self._mask_dev.shape[0]
        counts = np.zeros(pad_b, np.int64)
        counts[:self.batch_size] = self.n_classes
        # the solver reads the mask, never n_classes: the counts are report
        # surface only, so their device copy is kept until occupancy changes
        if (self._n_classes_dev is None
                or not np.array_equal(counts, self._n_classes_host)):
            self._n_classes_dev = _to_device(counts, self.device)
            self._n_classes_host = counts
        return ScenarioBatch(scenarios=self._scn, mask=self._mask_dev,
                             n_classes=self._n_classes_dev)

    def resident_warm_start(self, rbatch: ScenarioBatch
                            ) -> Tuple[game.BatchWarmStart, np.ndarray]:
        """Incremental-re-solve init of a resident flush, over the padded
        lanes (``sharding.resident_warm_init``); only the dirty flags are
        uploaded.

        Parameters
        ----------
        rbatch : ScenarioBatch
            The window's :meth:`resident_batch`.

        Returns
        -------
        (game.BatchWarmStart, np.ndarray)
            The padded init, and the (B,) host ``resolved`` flags: the lanes
            that will iterate (dirty or never solved).
        """
        self._check_resident()
        if self._state is None:
            return (sharding.resident_cold_init(rbatch),
                    np.ones(self.batch_size, bool))
        dirty = np.zeros(rbatch.batch_size, bool)
        dirty[:self.batch_size] = self.dirty
        init = sharding.resident_warm_init(rbatch, self._state,
                                           _to_device(dirty, self.device))
        # active == dirty here: a never-solved lane is always dirty (add_lane
        # makes the only unsolved rows, and dirties them)
        return init, self.dirty.copy()

    def _check_resident(self) -> None:
        if self._resident_mesh is None:
            raise RuntimeError(
                "window is not device-resident — call make_resident(mesh)")

    def _place_device_leaves(self) -> None:
        """(Re-)establish the resident layout: pad the lane axis to the mesh
        multiple where it is not, rebuild the device mask mirror from the
        host mask, pad the stored equilibrium."""
        B, n_max = self.batch_size, self.n_max
        pad_b = sharding.padded_lane_count(B, self._resident_mesh.devices.size)
        rows = self._scn.A.shape[0]
        if rows == B and pad_b > B:
            self._scn = sharding.pad_batch_lanes(self.batch, pad_b).scenarios
        elif rows not in (B, pad_b):
            raise AssertionError(
                f"resident lane-axis invariant broken: {rows} device rows, "
                f"B={B}, padded={pad_b}")
        full = np.zeros((pad_b, n_max), bool)
        full[:B] = self._mask
        self._mask_dev = _to_device(full, self.device)
        self._n_classes_dev = self._n_classes_host = None
        if self._state is not None:
            self._state = sharding.pad_window_state(self._state, pad_b)

    def _exit_residency(self) -> None:
        """Back to the logical layout: trim the padding lanes (row views)
        and drop the mask mirror."""
        b = self.batch_size

        def trim(leaf):
            return leaf[:b] if leaf.shape[0] > b else leaf

        self._scn = tree_map(trim, self._scn)
        if self._state is not None:
            self._state = WindowState(*map(trim, self._state))
        self._mask_dev = None
        self._n_classes_dev = self._n_classes_host = None
        self._resident_mesh = None

    @contextlib.contextmanager
    def _host_geometry(self):
        """Run a lane-geometry change (add / remove / compact) at the
        logical lane count, then re-establish residency, so that the
        geometry code never sees the padding."""
        mesh = self._resident_mesh
        if mesh is None:
            yield
            return
        self._exit_residency()
        try:
            yield
        finally:
            self.make_resident(mesh)

    # ------------------------------------------------------------------ events
    def apply(self, event: StreamEvent) -> Optional[int]:
        """Apply one event (an epoch of one); returns the assigned slot for
        arrivals.

        Parameters
        ----------
        event : StreamEvent
            One of ClassArrival, ClassDeparture, SLAEdit, CapacityChange.

        Returns
        -------
        int or None
            The slot granted to a :class:`ClassArrival`, else None.
        """
        return self.apply_epoch([event])[0]

    def apply_epoch(self, events: Sequence[StreamEvent]) -> List[Optional[int]]:
        """Fold MANY events into one atomic, coalesced window update.

        The same slot assignments, growth schedule and written values as
        applying ``events`` one by one with :meth:`apply`, but every class
        field takes one scatter for the whole epoch.  The update is atomic:
        events are validated against a host-side simulation of the whole
        epoch first, so an invalid event (unknown lane, departing an empty
        slot, bad SLA fields) raises before any state changes.

        Parameters
        ----------
        events : Sequence[StreamEvent]
            Events in application order (the order defines slot assignment
            for arrivals and the merge order of SLA edits).

        Returns
        -------
        list of (int or None)
            One entry per event: the slot granted to a
            :class:`ClassArrival`, None for every other kind.
        """
        events = list(events)
        if not events:
            return []
        # ---- simulate: net per-slot effect + validation, no mutation yet
        sim_mask = self._mask.copy()
        n_max, B = self.n_max, self.batch_size
        staged: Dict[Tuple[int, int], Optional[dict]] = {}  # None = vacated
        vacated: Set[Tuple[int, int]] = set()
        new_R: Dict[int, float] = {}
        granted: List[Optional[int]] = []
        for ev in events:
            if isinstance(ev, ClassArrival):
                self._check_lane(ev.lane)
                missing = set(RAW_CLASS_FIELDS) - set(ev.params)
                if missing:
                    raise ValueError(
                        f"class params missing fields {sorted(missing)}")
                free = np.flatnonzero(~sim_mask[ev.lane])
                if free.size == 0:                  # mirror self.grow
                    grown = grown_n_max(n_max, self.growth_factor)
                    sim_mask = np.concatenate(
                        [sim_mask, np.zeros((B, grown - n_max), bool)], axis=1)
                    n_max = grown
                    free = np.flatnonzero(~sim_mask[ev.lane])
                slot = int(free[0])
                sim_mask[ev.lane, slot] = True
                staged[(ev.lane, slot)] = dict(ev.params)
                granted.append(slot)
                continue
            granted.append(None)
            if isinstance(ev, ClassDeparture):
                self._check_lane(ev.lane)
                if not 0 <= ev.slot < n_max or not sim_mask[ev.lane, ev.slot]:
                    raise IndexError(
                        f"(lane={ev.lane}, slot={ev.slot}) holds no class")
                sim_mask[ev.lane, ev.slot] = False
                staged[(ev.lane, ev.slot)] = None
                vacated.add((ev.lane, ev.slot))
            elif isinstance(ev, SLAEdit):
                self._check_lane(ev.lane)
                if not 0 <= ev.slot < n_max or not sim_mask[ev.lane, ev.slot]:
                    raise IndexError(
                        f"(lane={ev.lane}, slot={ev.slot}) holds no class")
                bad = set(ev.updates) - set(RAW_CLASS_FIELDS)
                if bad:
                    raise ValueError(f"unknown raw fields {sorted(bad)}")
                base = (staged[(ev.lane, ev.slot)]
                        if (ev.lane, ev.slot) in staged
                        else self._raw[(ev.lane, ev.slot)])
                staged[(ev.lane, ev.slot)] = {**base, **ev.updates}
            elif isinstance(ev, CapacityChange):
                self._check_lane(ev.lane)
                new_R[ev.lane] = float(ev.R)
            else:
                raise TypeError(f"unknown event {ev!r}")

        # ---- commit: grow once, host bookkeeping, one scatter per field
        if n_max > self.n_max:
            self.grow(n_max)
        dt, dev = self._scn.A.dtype, self.device
        kw = {}
        if staged:
            keys = sorted(staged)
            neutral = neutral_class_values(0.0)
            vals = np.empty((len(_CLASS_FIELDS), len(keys)), _np_dtype(dt))
            for j, f in enumerate(_CLASS_FIELDS):
                vals[j] = neutral[f]
            for i, k in enumerate(keys):            # vacated slots go neutral
                if staged[k] is None:
                    vals[_RHO_UP, i] = self._rho_bar_host[k[0]]
            occ = np.asarray([staged[k] is not None for k in keys])
            occ_pos = np.flatnonzero(occ)
            vals_dev = _to_device(vals, dev)
            if occ_pos.size:
                derived = _derive_classes([staged[keys[i]] for i in occ_pos],
                                          dt, dev)
                vals_dev.index_copy_(
                    1, _to_device(occ_pos, dev),
                    torch.stack([derived[f] for f in _CLASS_FIELDS]))
            li, si = _to_device(np.asarray(keys, np.int64).T, dev)
            occ_dev = _to_device(occ, dev)
            kw = {f: getattr(self._scn, f).index_put((li, si), vals_dev[j])
                  for j, f in enumerate(_CLASS_FIELDS)}
            for k in keys:
                occupied = staged[k] is not None
                self._mask[k] = occupied
                if occupied:
                    self._raw[k] = dict(staged[k])
                else:
                    self._raw.pop(k, None)
            if self._mask_dev is not None:           # the resident mirror
                self._mask_dev = self._mask_dev.index_put((li, si), occ_dev)
            if vacated and self._state is not None:
                # vacated slots restart from 0; occupied staged slots keep
                # their stored allocation (their lane goes dirty anyway)
                r = self._state.r
                kept = torch.where(occ_dev, r[li, si],
                                   torch.zeros((), dtype=r.dtype, device=dev))
                self._state = self._state._replace(
                    r=r.index_put((li, si), kept))
        if new_R:
            lanes = sorted(new_R)
            kw["R"] = self._scn.R.index_put(
                (_to_device(np.asarray(lanes, np.int64), dev),),
                _to_device(np.asarray([new_R[b] for b in lanes],
                                      _np_dtype(dt)), dev))
        class_lanes = sorted({k[0] for k in staged})
        if class_lanes:
            # rho_hat = max rho_up over admitted classes (paper (P5e)
            # interval end); an empty lane falls back to rho_bar
            lanes_dev = _to_device(np.asarray(class_lanes, np.int64), dev)
            rows = _to_device(self._mask[class_lanes], dev)
            hats = torch.where(rows, kw["rho_up"][lanes_dev],
                               self._scn.rho_bar[lanes_dev][:, None]).amax(1)
            kw["rho_hat"] = self._scn.rho_hat.index_put((lanes_dev,), hats)
        if kw:
            self._scn = self._scn.replace(**kw)
        for lane in {*class_lanes, *new_R}:
            self._mark_dirty(lane)
        return granted

    def arrive(self, lane: int, **params) -> int:
        """Admit a new class to ``lane`` (raw scalars, exactly
        :data:`RAW_CLASS_FIELDS`); returns its slot, the lowest free one
        (the window grows only when the lane's row is full)."""
        return self.apply_epoch([ClassArrival(lane=lane, params=params)])[0]

    def depart(self, lane: int, slot: int) -> None:
        """Remove the class at (lane, slot); the slot becomes recyclable."""
        self.apply_epoch([ClassDeparture(lane=lane, slot=slot)])

    def edit(self, lane: int, slot: int, **updates) -> None:
        """Renegotiate the class at (lane, slot): overwrite a subset of its
        :data:`RAW_CLASS_FIELDS` and re-derive its constants."""
        self.apply_epoch([SLAEdit(lane=lane, slot=slot, updates=updates)])

    def set_capacity(self, lane: int, R: float) -> None:
        """Set lane capacity R (node failures / restores, paper Fig. 2)."""
        self.apply_epoch([CapacityChange(lane=lane, R=R)])

    def grow(self, new_n_max: int) -> None:
        """Repad every (B, n_max) leaf to ``new_n_max`` columns.

        Padding is solver-inert (neutral classes, mask False), so stored
        equilibria of clean lanes remain exact across growth.  A resident
        window grows its actual rows, padding lanes included (their
        ``rho_bar`` is 1, so their ``rho_up`` fill stays the inert 1), and
        re-places them.
        """
        old = self.n_max
        if new_n_max <= old:
            raise ValueError(f"new_n_max={new_n_max} must exceed {old}")
        B, pad = self.batch_size, new_n_max - old
        rows = self._scn.A.shape[0]
        neutral = neutral_class_values(0.0)
        kw = {}
        for f in _CLASS_FIELDS:
            leaf = getattr(self._scn, f)
            if f == "rho_up":
                fill = self._scn.rho_bar[:, None].expand(rows, pad)
            else:
                fill = leaf.new_full((rows, pad), neutral[f])
            kw[f] = torch.cat([leaf, fill], dim=1)
        self._scn = self._scn.replace(**kw)
        self._mask = np.concatenate(
            [self._mask, np.zeros((B, pad), bool)], axis=1)
        if self._state is not None:
            r = self._state.r
            self._state = self._state._replace(
                r=torch.cat([r, r.new_zeros((r.shape[0], pad))], dim=1))
        if self._resident_mesh is not None:
            self._place_device_leaves()

    # ------------------------------------------------------- dynamic lanes
    def add_lane(self, scn: Optional[Scenario] = None, *,
                 R: Optional[float] = None,
                 rho_bar: Optional[float] = None) -> int:
        """Append one lane (a new cluster joining the window).

        Stored equilibria of existing lanes are untouched; the new lane
        starts dirty and never solved, so the next solve iterates it (plus
        any other dirty lanes).  Call between solves.

        Parameters
        ----------
        scn : Scenario, optional
            Initial classes of the new lane (the window grows first if
            ``scn.n`` exceeds ``n_max``).  ``None`` admits an empty lane:
            neutral classes, ``rho_up = rho_hat = rho_bar``.
        R, rho_bar : float, optional
            Lane capacity and unit chip cost, required when ``scn`` is None.

        Returns
        -------
        int
            The new lane's index (the previous ``batch_size``).
        """
        if scn is None and (R is None or rho_bar is None):
            raise ValueError("an empty lane needs explicit R= and rho_bar=")
        with self._host_geometry():
            if scn is not None and scn.n > self.n_max:
                self.grow(int(scn.n))
            b, n_max = self.batch_size, self.n_max
            dt, dev = self._scn.A.dtype, self.device
            if scn is not None:
                row = pad_scenario(scn, n_max)
                new = {f.name: getattr(row, f.name).to(dev, dt)[None]
                       for f in dataclasses.fields(Scenario)}
            else:
                neutral = {**neutral_class_values(1.0),
                           "rho_up": float(rho_bar)}
                scalars = {"R": float(R), "rho_bar": float(rho_bar),
                           "rho_hat": float(rho_bar)}
                new = {f: torch.full((1, n_max), v, dtype=dt, device=dev)
                       for f, v in neutral.items()}
                new.update({f: torch.full((1,), v, dtype=dt, device=dev)
                            for f, v in scalars.items()})
            self._scn = self._scn.replace(**{
                f: torch.cat([getattr(self._scn, f), t])
                for f, t in new.items()})
            self._mask = np.concatenate(
                [self._mask, np.zeros((1, n_max), bool)], axis=0)
            if scn is not None:
                self._mask[b, :scn.n] = True
                cols = {f: getattr(scn, f).cpu().numpy()
                        for f in RAW_CLASS_FIELDS}
                for i in range(scn.n):
                    self._raw[(b, i)] = {f: float(cols[f][i])
                                         for f in RAW_CLASS_FIELDS}
            if self._state is not None:
                st = self._state
                self._state = WindowState(
                    r=torch.cat([st.r, st.r.new_zeros((1, n_max))]),
                    rho=torch.cat([st.rho, st.rho.new_ones((1,))]),
                    lane_iters=torch.cat([st.lane_iters,
                                          st.lane_iters.new_zeros((1,))]),
                    solved=torch.cat([st.solved, st.solved.new_zeros((1,))]))
            self.dirty = np.append(self.dirty, True)
            self.baseline_totals = np.append(self.baseline_totals, np.nan)
            self.baseline_stale = np.append(self.baseline_stale, True)
            self._rho_bar_host = (
                self._scn.rho_bar.double().cpu().numpy().copy())
        return b

    def remove_lane(self, lane: int) -> None:
        """Drop ``lane`` (a cluster leaving) and shrink B by one.

        Lanes above ``lane`` shift down by one, their stored equilibria with
        them, so clean lanes stay frozen.  Call between solves.
        """
        self._check_lane(lane)
        if self.batch_size == 1:
            raise ValueError("cannot remove the last lane")

        def drop(t):
            return torch.cat([t[:lane], t[lane + 1:]])
        with self._host_geometry():
            self._scn = self._scn.replace(
                **{f.name: drop(getattr(self._scn, f.name))
                   for f in dataclasses.fields(Scenario)})
            self._mask = np.delete(self._mask, lane, axis=0)
            self.dirty = np.delete(self.dirty, lane)
            self.baseline_totals = np.delete(self.baseline_totals, lane)
            self.baseline_stale = np.delete(self.baseline_stale, lane)
            if self._state is not None:
                self._state = WindowState(*map(drop, self._state))
            self._raw = {(b - (b > lane), s): raw
                         for (b, s), raw in self._raw.items() if b != lane}
            self._rho_bar_host = np.delete(self._rho_bar_host, lane)

    def compact(self, *, n_max: Optional[int] = None) -> np.ndarray:
        """Re-pack every lane's admitted classes into a slot prefix.

        Each lane's classes move to slots ``0..k-1`` in their order,
        ``n_max`` shrinks to the widest lane (or the requested width), and
        the stored equilibrium and raw parameters are remapped the same way,
        so clean lanes stay frozen through the next solve.  Dirty flags and
        memoized baselines are untouched.  Call between solves: pending
        events address classes by their old slots.

        Parameters
        ----------
        n_max : int, optional
            Target padded width; defaults to the widest lane's class count
            (floor 1).  Must be at least that.

        Returns
        -------
        np.ndarray
            (B, old_n_max) int64 map: old slot -> new slot, -1 where the
            old slot held no class.
        """
        counts = self._mask.sum(axis=1)
        min_width = max(int(counts.max()), 1)
        target = min_width if n_max is None else int(n_max)
        if target < min_width:
            raise ValueError(
                f"n_max={target} below the widest lane ({min_width})")
        B, old = self.batch_size, self.n_max
        slot_map = np.full((B, old), -1, np.int64)
        src = np.zeros((B, target), np.int64)
        for b in range(B):
            occ = np.flatnonzero(self._mask[b])
            slot_map[b, occ] = np.arange(occ.size)
            src[b, :occ.size] = occ
        new_mask = np.arange(target)[None, :] < counts[:, None]
        if target == old and np.array_equal(new_mask, self._mask):
            return slot_map                      # already packed at this width
        with self._host_geometry():
            src_dev = _to_device(src, self.device)
            nm = _to_device(new_mask, self.device)
            neutral = neutral_class_values(0.0)
            kw = {}
            for f in _CLASS_FIELDS:
                gathered = torch.gather(getattr(self._scn, f), 1, src_dev)
                fill = (self._scn.rho_bar[:, None] if f == "rho_up"
                        else neutral[f])
                kw[f] = torch.where(nm, gathered, fill)
            self._scn = self._scn.replace(**kw)
            self._mask = new_mask
            self._raw = {(b, int(slot_map[b, s])): raw
                         for (b, s), raw in self._raw.items()}
            if self._state is not None:
                r = self._state.r
                self._state = self._state._replace(
                    r=torch.where(nm, torch.gather(r, 1, src_dev), 0.0))
        return slot_map

    # ------------------------------------------------------------ solver state
    def warm_start(self) -> game.BatchWarmStart:
        """Incremental-re-solve init for ``solve_distributed_batch``.

        Returns
        -------
        game.BatchWarmStart
            Clean, previously solved lanes are frozen at their stored
            equilibrium (``active`` False: zero iterations); dirty or
            never-solved lanes get the cold Algorithm 4.1 init, so they
            reproduce the cold trajectory exactly.
        """
        if self._resident_mesh is not None:
            raise RuntimeError(
                "resident windows build their init on the device — use "
                "resident_warm_start (or release_resident first)")
        cold = game.cold_start(self.batch)
        if self._state is None:
            return cold
        st = self._state
        frozen = st.solved & ~_to_device(self.dirty, self.device)
        return game.BatchWarmStart(
            r=torch.where(frozen[:, None], st.r, cold.r),
            bids=cold.bids,
            rho=torch.where(frozen, st.rho, cold.rho),
            lane_iters=torch.where(frozen, st.lane_iters,
                                   torch.zeros_like(st.lane_iters)),
            active=~frozen)

    def commit(self, r, rho, lane_iters) -> None:
        """Store a fresh equilibrium and mark every lane clean.

        Parameters
        ----------
        r : torch.Tensor
            (B, n_max) equilibrium allocation of the just-finished solve.
        rho : torch.Tensor
            (B,) final RM prices (``Solution.aux``).
        lane_iters : torch.Tensor
            (B,) per-lane iteration counts (``Solution.iters``).
        """
        dt, dev = self._scn.A.dtype, self.device
        r = torch.as_tensor(r, device=dev).to(dt)
        self._state = WindowState(
            r=r, rho=torch.as_tensor(rho, device=dev).to(dt),
            lane_iters=torch.as_tensor(lane_iters, device=dev).to(torch.int32),
            solved=torch.ones((r.shape[0],), dtype=torch.bool, device=dev))
        self.dirty[:] = False

    # -------------------------------------------------------------- internals
    def _mark_dirty(self, lane: int) -> None:
        self.dirty[lane] = True
        self.baseline_stale[lane] = True

    def _check_lane(self, lane: int) -> None:
        if not 0 <= lane < self.batch_size:
            raise IndexError(f"lane {lane} out of range [0, {self.batch_size})")


def grown_n_max(n_max: int, growth_factor: float) -> int:
    """Deterministic growth schedule shared by the window and trace tools:
    ``max(ceil(growth_factor * n_max), n_max + 1)``."""
    return max(int(math.ceil(n_max * growth_factor)), n_max + 1)


# --------------------------------------------------------------------------
# Event coalescing: fold many events into one re-solve epoch
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class FlushPolicy:
    """When should a buffered event epoch stop accumulating and re-solve?

    Count and dirty-fraction triggers compose with OR; a policy with both
    None never auto-flushes.  The deadline-aware triggers (:meth:`deadline`)
    force an immediate flush for SLA-critical events.

    Attributes
    ----------
    max_events : int, optional
        Flush once this many events are buffered.
    max_dirty_fraction : float, optional
        Flush once the prospective dirty-lane fraction (window-dirty plus
        buffered lanes, over B) reaches this value.
    deadline_slack_s : float, optional
        An arrival or deadline edit landing at ``E >= -deadline_slack_s``
        flushes immediately; ``None`` disables the trigger.
    flush_on_sla_tightening : bool
        Flush immediately on any :class:`SLAEdit` that raises a class's
        ``E`` toward 0.
    """
    max_events: Optional[int] = 8
    max_dirty_fraction: Optional[float] = None
    deadline_slack_s: Optional[float] = None
    flush_on_sla_tightening: bool = False

    @classmethod
    def deadline(cls, slack_s: float, *, max_events: Optional[int] = 64,
                 max_dirty_fraction: Optional[float] = None,
                 tightening: bool = True) -> "FlushPolicy":
        """Deadline-aware policy: SLA-critical events flush immediately,
        bulk events coalesce up to ``max_events``.

        Parameters
        ----------
        slack_s : float
            Criticality threshold [s] on ``E = C - D``: events with
            ``E >= -slack_s`` are critical.
        max_events : int, optional
            Bulk coalescing bound (default 64).
        max_dirty_fraction : float, optional
            Optional bulk dirty-fraction trigger.
        tightening : bool, optional
            Also flush on every deadline-tightening SLA edit (default True).
        """
        return cls(max_events=max_events,
                   max_dirty_fraction=max_dirty_fraction,
                   deadline_slack_s=float(slack_s),
                   flush_on_sla_tightening=tightening)

    def is_critical(self, event: StreamEvent,
                    window: "AdmissionWindow") -> bool:
        """Does ``event`` demand an immediate flush (deadline triggers)?

        Tightening is judged against the class's ``E`` in the live window
        (an edit to a class that arrived earlier in the same epoch is judged
        by the slack threshold only).
        """
        slack = self.deadline_slack_s
        if isinstance(event, ClassArrival):
            return (slack is not None
                    and float(event.params.get("E", -np.inf)) >= -slack)
        if isinstance(event, SLAEdit) and "E" in event.updates:
            new_E = float(event.updates["E"])
            if slack is not None and new_E >= -slack:
                return True
            if self.flush_on_sla_tightening:
                old = window._raw.get((event.lane, event.slot))
                return old is not None and new_E > float(old["E"])
        return False

    def should_flush(self, *, n_events: int, n_dirty: int,
                     batch_size: int) -> bool:
        """Whether a count or dirty-fraction trigger fires for an epoch of
        ``n_events`` buffered events touching ``n_dirty`` of ``batch_size``
        lanes."""
        if self.max_events is not None and n_events >= self.max_events:
            return True
        if (self.max_dirty_fraction is not None and batch_size > 0
                and n_dirty / batch_size >= self.max_dirty_fraction):
            return True
        return False


class EventEpoch:
    """Accumulate events against a window; one coalesced solve per flush.

    Events buffer on the host; :meth:`flush` folds them into the window with
    :meth:`AdmissionWindow.apply_epoch` and re-solves once, warm-started,
    over the union of dirtied lanes.

    Parameters
    ----------
    window : AdmissionWindow
        The live window; mutated only at flush.
    policy : FlushPolicy, optional
        Auto-flush triggers consulted by :meth:`add` (default: every 8
        events).

    Attributes
    ----------
    flushes : int
        Completed flushes.
    events_folded : int
        Total events applied across all flushes.
    last_slots : list
        Per-event slot grants of the most recent flush.
    """

    def __init__(self, window: AdmissionWindow,
                 policy: Optional[FlushPolicy] = None):
        self.window = window
        self.policy = policy or FlushPolicy()
        self._events: List[StreamEvent] = []
        self.flushes = 0
        self.events_folded = 0
        self.last_slots: List[Optional[int]] = []

    def __len__(self) -> int:
        return len(self._events)

    @property
    def pending(self) -> Tuple[StreamEvent, ...]:
        """Buffered, not-yet-applied events (application order)."""
        return tuple(self._events)

    @property
    def dirty_lanes(self) -> Set[int]:
        """Lanes the next flush will re-solve: window-dirty | buffered."""
        return ({int(b) for b in np.flatnonzero(self.window.dirty)}
                | {ev.lane for ev in self._events})

    def add(self, event: StreamEvent) -> bool:
        """Buffer one event; True when the policy's triggers fire (an
        SLA-critical event included) and the caller should :meth:`flush`."""
        self._events.append(event)
        return (self.policy.is_critical(event, self.window)
                or self.policy.should_flush(
                    n_events=len(self._events),
                    n_dirty=len(self.dirty_lanes),
                    batch_size=self.window.batch_size))

    def flush(self, *, eps_bar: float = 0.03, lam: float = 0.05,
              max_iters: int = 200, integer: bool = True, sweep_fn=None,
              mesh=None, cross_check: bool = False,
              cross_check_atol: float = 1e-6):
        """Apply the buffered events and re-solve the window once through
        ``engine._legacy_solve_window`` (an engine built from these solver
        knobs and policies on the window's device; no deprecation warning).

        Returns
        -------
        repro_torch.core.engine.WindowSolveReport
            The coalesced re-solve (an empty flush with a clean window is
            legal: every lane freezes).
        """
        from repro_torch.core.engine import _legacy_solve_window
        self.last_slots = self.window.apply_epoch(self._events)
        self.events_folded += len(self._events)
        self._events = []
        res = _legacy_solve_window(self.window, eps_bar=eps_bar, lam=lam,
                                   max_iters=max_iters, integer=integer,
                                   sweep_fn=sweep_fn, mesh=mesh,
                                   cross_check=cross_check,
                                   cross_check_atol=cross_check_atol)
        self.flushes += 1
        return res


# --------------------------------------------------------------------------
# Event-trace generation
# --------------------------------------------------------------------------


def sample_event_trace(seed: int, window: AdmissionWindow, n_events: int, *,
                       p_arrive: float = 0.45, p_depart: float = 0.30,
                       p_edit: float = 0.15, p_capacity: float = 0.10,
                       params_fn=None) -> List[StreamEvent]:
    """Random, replayable event trace applicable to ``window`` (unmutated).

    The generator simulates the window's slot-assignment and growth rules on
    a host copy of the occupancy mask, so departures and edits always
    address slots that are occupied when the trace is applied in order.
    The structure (kinds, lanes, slots, capacities) comes from
    ``np.random.default_rng(seed)`` exactly as in the JAX package, so both
    packages draw the same structure at the same seed; class parameters
    come from a ``torch.Generator`` seeded with ``seed``.

    Parameters
    ----------
    seed : int
        Seeds the structural generator and the parameter draws.
    window : AdmissionWindow
        Snapshot defining initial occupancy, ``n_max``, capacities and
        growth factor.
    n_events : int
        Trace length.
    p_arrive, p_depart, p_edit, p_capacity : float, optional
        Event-kind mixture (renormalised).  Departures and edits of an
        all-empty window fall back to arrivals.
    params_fn : callable, optional
        ``params_fn(gen) -> dict`` drawing one class's raw parameters from a
        ``torch.Generator``; defaults to
        :func:`repro_torch.core.profiles.sample_class_params`.

    Returns
    -------
    list of StreamEvent
        Events in application order.
    """
    params_fn = params_fn or sample_class_params
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    probs = np.asarray([p_arrive, p_depart, p_edit, p_capacity], float)
    probs = probs / probs.sum()

    mask = window._mask.copy()
    n_max = window.n_max
    R = window._scn.R.double().cpu().numpy().copy()
    B = mask.shape[0]

    events: List[StreamEvent] = []
    for _ in range(n_events):
        kind = rng.choice(4, p=probs)
        occupied = np.argwhere(mask)
        if kind in (1, 2) and occupied.size == 0:
            kind = 0
        if kind == 0:                                   # arrival
            lane = int(rng.integers(B))
            events.append(ClassArrival(lane=lane, params=params_fn(gen)))
            free = np.flatnonzero(~mask[lane])
            if free.size == 0:                          # mirror window.grow
                new = grown_n_max(n_max, window.growth_factor)
                mask = np.concatenate(
                    [mask, np.zeros((B, new - n_max), bool)], axis=1)
                n_max = new
                free = np.flatnonzero(~mask[lane])
            mask[lane, int(free[0])] = True
        elif kind == 1:                                 # departure
            lane, slot = occupied[rng.integers(len(occupied))]
            events.append(ClassDeparture(lane=int(lane), slot=int(slot)))
            mask[lane, slot] = False
        elif kind == 2:                                 # SLA edit
            lane, slot = occupied[rng.integers(len(occupied))]
            fresh = params_fn(gen)
            events.append(SLAEdit(
                lane=int(lane), slot=int(slot),
                updates={k: fresh[k]
                         for k in ("E", "m", "rho_up", "H_up", "H_low")}))
        else:                                           # capacity change
            lane = int(rng.integers(B))
            R[lane] *= float(rng.uniform(0.9, 1.1))
            events.append(CapacityChange(lane=lane, R=float(R[lane])))
    return events


def replay(window: AdmissionWindow, events: Sequence[StreamEvent]) -> None:
    """Apply ``events`` to ``window`` in order, one by one (no solving)."""
    for ev in events:
        window.apply(ev)
