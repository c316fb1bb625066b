"""Lane-parallel GNEP solves over a 1-D device mesh (PyTorch).

Counterpart of ``repro.core.sharding``.  The batched engine
(``game.solve_distributed_batch``) solves B independent lanes in one loop;
this module splits those lanes into contiguous slices, one for each device
of a 1-D :class:`LaneMesh`, and solves each slice with its own loop:

* :func:`lane_mesh` builds the mesh over the ``"lanes"`` axis.  A device may
  appear more than once: ``lane_mesh(devices=["cpu"] * 4)`` is a 4-shard
  mesh on the one CPU device, and ``["cuda:0"] * 3`` three shards on one
  card (torch has one CPU device, where the reference forces XLA host
  devices);
* :func:`pad_batch_lanes` pads the lane count to a multiple of the device
  count with *inert* lanes: an all-False mask row and unit scalars
  (``types.neutral_class_values``), so an inert lane converges in one
  iteration and never changes a real lane;
* :func:`solve_sharded_batch` runs Algorithm 4.1 on each lane slice in
  turn, each with its own loop, which exits when its own lanes converge.
  Every update is lane-local and converged lanes are frozen, so each slice
  reproduces its lanes' unsharded trajectories, and the result equals the
  unsharded solve wherever the loop's plain ops give each row the same
  bits at any row count;
* :func:`solve_resident_batch` is the flush of a device-resident window:
  its batch and warm start stay at the padded lane count across flushes,
  and so does its result.

Layout: a lane-sharded tensor is one tensor at the padded lane count on
``mesh.devices[0]``.  Shard ``d`` is ``leaf.narrow(0, d * B / D, B / D)``,
a view where ``devices[d]`` is ``devices[0]`` and a copy to ``devices[d]``
otherwise (its results are copied back).  Nothing is compiled, so the
reference's program caches have no counterpart, and nothing is donated: a
resident solve allocates its result afresh, and no update writes in place.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import game
from repro_torch.core.types import (Scenario, ScenarioBatch, Solution,
                                    WindowState, neutral_class_values)
from repro_torch.utils import indexed_device, resolve_device, tree_map

#: Default name of the single mesh axis the lane dimension is split over.
LANE_AXIS = "lanes"


@dataclass(frozen=True, eq=False)
class LaneMesh:
    """A 1-D mesh of devices the lane axis is split over.

    Attributes
    ----------
    devices : np.ndarray
        (D,) object array of ``torch.device`` (repeats allowed).
    axis_names : tuple of str
        The mesh's axis names, ``(LANE_AXIS,)`` from :func:`lane_mesh`.
    """
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def _key(self):
        return (tuple(self.devices.shape), tuple(map(str, self.devices.flat)),
                tuple(self.axis_names))

    def __eq__(self, other):
        return isinstance(other, LaneMesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def lane_mesh(n_devices: Optional[int] = None, *,
              devices: Optional[Sequence] = None) -> LaneMesh:
    """Build the 1-D device mesh the lane axis is split over.

    Parameters
    ----------
    n_devices : int, optional
        How many CUDA devices to take (default every visible one); ignored
        when ``devices`` is given.
    devices : sequence of str or torch.device, optional
        Explicit device list, repeats allowed (``["cpu"] * 4``).

    Returns
    -------
    LaneMesh
        For every ``mesh=`` parameter of the solver stack.

    Raises
    ------
    RuntimeError
        When CUDA devices are asked for (the default) and CUDA is absent.
    ValueError
        For an empty device list or ``n_devices`` out of range.
    """
    if devices is None:
        if n_devices is not None and int(n_devices) < 1:
            raise ValueError(f"n_devices={n_devices} must be >= 1")
        resolve_device("cuda")
        avail = torch.cuda.device_count()
        n = avail if n_devices is None else int(n_devices)
        if not 1 <= n <= avail:
            raise ValueError(f"n_devices={n} out of range [1, {avail}] (pass "
                             "devices=[...] to repeat a device)")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [indexed_device(d) for d in devices]
    if not devs:
        raise ValueError("a lane mesh needs at least one device")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return LaneMesh(arr, (LANE_AXIS,))


def lane_sharding(mesh: LaneMesh) -> LaneMesh:
    """The placement every lane-axis leaf of a batch, warm start, window
    state or solution uses on ``mesh`` (all carry the lane dim first).

    The layout needs nothing beyond the mesh: the whole tensor lies on
    ``mesh.devices[0]`` and shard ``d`` is its ``d``-th contiguous row slice.
    Returns ``mesh`` after checking that it is 1-D.
    """
    _check_1d(mesh)
    return mesh


def _check_1d(mesh: LaneMesh) -> None:
    if len(mesh.axis_names) != 1 or mesh.devices.ndim != 1:
        raise ValueError(
            f"lane sharding needs a 1-D mesh, got axes {mesh.axis_names}")


def shard_batch(batch: ScenarioBatch, mesh: LaneMesh) -> ScenarioBatch:
    """Pad ``batch`` to the mesh's lane multiple and place it on the mesh.

    Solves of the returned batch return the PADDED lane count (the inert
    lanes are part of the batch from here on).
    """
    home = lane_sharding(mesh).devices[0]
    padded = pad_batch_lanes(
        batch, padded_lane_count(batch.batch_size, mesh.devices.size))
    return tree_map(lambda leaf: leaf.to(home), padded)


def padded_lane_count(batch_size: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` that is >= ``batch_size``."""
    if batch_size < 1 or n_shards < 1:
        raise ValueError("batch_size and n_shards must be >= 1")
    return -(-batch_size // n_shards) * n_shards


def _check_target(b: int, target_b: int) -> None:
    if target_b < b:
        raise ValueError(f"target_b={target_b} < batch_size={b}")


def pad_batch_lanes(batch: ScenarioBatch, target_b: int) -> ScenarioBatch:
    """Append inert lanes so ``batch`` has exactly ``target_b`` lanes.

    An inert lane holds a row of neutral classes
    (``types.neutral_class_values(1.0)``), an all-False mask row, zero
    classes and unit scalars (``R = rho_bar = rho_hat = 1``): every solver
    formula stays finite, the lane is feasible, and its convergence metric
    is 0.  Returns ``batch`` itself when it already has ``target_b`` lanes.
    """
    b = batch.batch_size
    if target_b == b:
        return batch
    _check_target(b, target_b)
    pad, n_max = target_b - b, batch.n_max
    scn = batch.scenarios
    neutral = neutral_class_values(1.0)
    kw = {}
    for f in dataclasses.fields(Scenario):
        leaf = getattr(scn, f.name)
        if f.name in neutral:                           # per class (B, n_max)
            fill = leaf.new_full((pad, n_max), neutral[f.name])
        else:                                           # scalar (B,)
            fill = leaf.new_ones((pad,))
        kw[f.name] = torch.cat([leaf, fill])
    return ScenarioBatch(
        scenarios=Scenario(**kw),
        mask=torch.cat([batch.mask, batch.mask.new_zeros((pad, n_max))]),
        n_classes=torch.cat([batch.n_classes,
                             batch.n_classes.new_zeros((pad,))]))


def pad_warm_start(init: game.BatchWarmStart,
                   target_b: int) -> game.BatchWarmStart:
    """Append *frozen* inert-lane state so ``init`` covers ``target_b`` lanes:
    ``active = False`` (zero iterations), a zero allocation, bids and price
    at the inert lane's ``rho_bar = 1``.  Returns ``init`` itself when it
    already has ``target_b`` lanes."""
    b = init.active.shape[0]
    if target_b == b:
        return init
    _check_target(b, target_b)
    pad, n_max = target_b - b, init.r.shape[1]
    return game.BatchWarmStart(
        r=torch.cat([init.r, init.r.new_zeros((pad, n_max))]),
        bids=torch.cat([init.bids, init.bids.new_ones((pad, n_max))]),
        rho=torch.cat([init.rho, init.rho.new_ones((pad,))]),
        lane_iters=torch.cat([init.lane_iters,
                              init.lane_iters.new_zeros((pad,))]),
        active=torch.cat([init.active, init.active.new_zeros((pad,))]))


def pad_window_state(state: WindowState, target_b: int) -> WindowState:
    """Append inert-lane equilibrium rows so ``state`` covers ``target_b``
    lanes: a zero allocation, price 1, zero iterations and ``solved = True``,
    so a resident warm start freezes them as :func:`pad_warm_start` does.
    Returns ``state`` itself when it already has ``target_b`` lanes."""
    b = state.solved.shape[0]
    if target_b == b:
        return state
    _check_target(b, target_b)
    pad, n_max = target_b - b, state.r.shape[1]
    return WindowState(
        r=torch.cat([state.r, state.r.new_zeros((pad, n_max))]),
        rho=torch.cat([state.rho, state.rho.new_ones((pad,))]),
        lane_iters=torch.cat([state.lane_iters,
                              state.lane_iters.new_zeros((pad,))]),
        solved=torch.cat([state.solved, state.solved.new_ones((pad,))]))


def resident_warm_init(batch: ScenarioBatch, state: WindowState,
                       dirty: torch.Tensor) -> game.BatchWarmStart:
    """The warm start of a resident window solve, over its padded lanes.

    Frozen lanes (``state.solved`` and not ``dirty``) pass their stored
    equilibrium through with ``active = False``; dirty or never-solved lanes
    restart from the cold Algorithm 4.1 init.  The same values as
    ``AdmissionWindow.warm_start`` + :func:`pad_warm_start`, built on the
    window's device from its resident tensors.

    Parameters
    ----------
    batch : ScenarioBatch
        The resident (lane-padded) batch.
    state : WindowState
        Committed equilibrium over the same padded lane count.
    dirty : torch.Tensor
        (padded B,) bool on the batch's device; padding rows False.
    """
    cold = game.cold_start(batch)
    frozen = state.solved & ~dirty
    return game.BatchWarmStart(
        r=torch.where(frozen[:, None], state.r, cold.r),
        bids=cold.bids,
        rho=torch.where(frozen, state.rho, cold.rho),
        lane_iters=torch.where(frozen, state.lane_iters,
                               torch.zeros_like(state.lane_iters)),
        active=~frozen)


def resident_cold_init(batch: ScenarioBatch) -> game.BatchWarmStart:
    """The cold Algorithm 4.1 init of a resident batch (``game.cold_start``:
    every tensor fresh, every lane active)."""
    return game.cold_start(batch)


def _check_home(batch: ScenarioBatch, mesh: LaneMesh) -> None:
    """The batch must lie on the mesh's first device: a solve never moves a
    batch to a mesh elsewhere (a card batch onto a CPU mesh would run the
    plain path)."""
    if batch.device != mesh.devices[0]:
        raise ValueError(
            f"the batch lies on {batch.device}, the mesh starts on "
            f"{mesh.devices[0]}: build the mesh on the batch's device or "
            "place the batch with shard_batch")


def _concat(parts: List[Solution], home: torch.device) -> Solution:
    if len(parts) == 1:
        return parts[0]
    return Solution(**{
        f.name: torch.cat([getattr(p, f.name).to(home) for p in parts])
        for f in dataclasses.fields(Solution)})


def _solve_shards(batch: ScenarioBatch, mesh: LaneMesh, eps_bar, lam,
                  max_iters, sweep_fn, init, iter_fn) -> Solution:
    """Algorithm 4.1 on each lane slice of a padded, home-placed batch, one
    loop a slice, in device order; the results concatenated at home."""
    n_dev = lane_sharding(mesh).devices.size
    n = batch.batch_size // n_dev
    parts = []
    for d in range(n_dev):
        def shard(leaf, d=d):
            return leaf.narrow(0, d * n, n).to(mesh.devices[d])
        sub = tree_map(shard, batch)
        sub_init = None if init is None else tree_map(shard, init)
        parts.append(game._solve_batch_core(sub, eps_bar, lam, max_iters,
                                            sweep_fn, sub_init,
                                            iter_fn=iter_fn))
    return _concat(parts, mesh.devices[0])


def solve_resident_batch(batch: ScenarioBatch, mesh: LaneMesh, *,
                         eps_bar: float = 0.03, lam: float = 0.05,
                         max_iters: int = 200, sweep_fn=None,
                         init: game.BatchWarmStart, iter_fn=None) -> Solution:
    """Algorithm 4.1 over an already lane-padded, mesh-placed batch.

    The flush of a device-resident window: ``batch`` is padded to the mesh
    multiple and lies on ``mesh.devices[0]`` (a resident ``AdmissionWindow``
    keeps it so), and ``init`` comes from :func:`resident_warm_init` /
    :func:`resident_cold_init`.  Nothing is padded, placed or trimmed: the
    returned :class:`Solution` keeps the PADDED lane count.

    Raises
    ------
    ValueError
        For a mesh that is not 1-D, a lane count that is not a multiple of
        the device count, or a batch off the mesh's first device.
    """
    _check_1d(mesh)
    if batch.batch_size % mesh.devices.size:
        raise ValueError(
            f"resident batch has {batch.batch_size} lanes, not a multiple "
            f"of the {mesh.devices.size}-device mesh — pad with "
            "pad_batch_lanes/padded_lane_count first")
    _check_home(batch, mesh)
    return _solve_shards(batch, mesh, eps_bar, lam, max_iters, sweep_fn,
                         init, iter_fn)


def solve_sharded_batch(batch: ScenarioBatch, mesh: LaneMesh, *,
                        eps_bar: float = 0.03, lam: float = 0.05,
                        max_iters: int = 200, sweep_fn=None,
                        init: Optional[game.BatchWarmStart] = None,
                        iter_fn=None) -> Solution:
    """Algorithm 4.1 over B lanes split across the devices of ``mesh``.

    The semantics of ``game.solve_distributed_batch`` (per-lane
    trajectories, per-lane freezing, warm starts): the lanes are padded with
    inert lanes to a multiple of the device count, each contiguous slice is
    solved with its own loop, and the padding is trimmed off the result.

    Parameters
    ----------
    batch : ScenarioBatch
        B stacked instances on ``mesh.devices[0]``; B need not divide the
        device count.
    mesh : LaneMesh
        1-D mesh from :func:`lane_mesh`.
    eps_bar, lam, max_iters
        Stopping tolerance, bid-escalation step and per-slice iteration cap.
    sweep_fn, iter_fn : optional
        Kernel plug-ins as in ``game.solve_distributed_batch``; inside a
        slice they see the slice's ``(B/D, ...)`` tensors.
    init : game.BatchWarmStart, optional
        Warm start over the real B lanes; padded lanes are added frozen.

    Returns
    -------
    Solution
        Leaves carry the REAL leading B dim (padding trimmed).
    """
    _check_1d(mesh)
    _check_home(batch, mesh)
    b = batch.batch_size
    target = padded_lane_count(b, mesh.devices.size)
    padded = pad_batch_lanes(batch, target)
    init = None if init is None else pad_warm_start(init, target)
    sol = _solve_shards(padded, mesh, eps_bar, lam, max_iters, sweep_fn,
                        init, iter_fn)
    if target == b:
        return sol
    return tree_map(lambda leaf: leaf[:b], sol)
