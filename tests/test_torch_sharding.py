"""Parity of the port's lane sharding (``repro_torch.core.sharding``) with
the JAX package, and of sharded with unsharded solves inside the port.

The port's meshes repeat the CPU device (``lane_mesh(devices=["cpu"] * D)``);
the JAX side runs on conftest's eight forced host devices.  Inside the
port a sharded solve equals the unsharded one bit for bit: every update is
lane-local, and torch's CPU ops give a row the same bits at any row count.
Against JAX the engine tolerances hold (``tests/test_torch_engine.py``):
iterations, feasibility, prices and integer results exact, fractional
results within 64 ULPs of their scale; window reports as in
``tests/test_torch_window.py`` (1e-12 relative).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal, assert_ulp_close
from _torch_parity import (batch_pair, leaves, np_, port_events,
                           table5_raw, to_port_batch, window_pair)
from repro.core import engine as je
from repro.core import game as jg
from repro.core import sharding as js
from repro.core import streaming as jstream
from repro.kernels.gnep_iter.ops import make_fused_iter_fn as j_iter
from repro.kernels.gnep_sweep.ops import make_batched_sweep_fn as j_sweep
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.core import game as tg
from repro_torch.core import sharding as ts
from repro_torch.core import types as tt
from repro_torch.kernels.gnep_iter.ops import make_fused_iter_fn as t_iter
from repro_torch.kernels.gnep_sweep.ops import make_batched_sweep_fn as t_sweep

# deliberately not divisible by 2, 3, 4 or 8: exercises inert-lane padding
RAGGED = (5, 17, 9, 12, 3, 26, 7, 31, 11, 4, 8)
CONFIGS = {
    "default": ({}, {}),
    "sweep": ({"sweep_fn": j_sweep()}, {"sweep_fn": t_sweep()}),
    "fused": ({"iter_fn": j_iter()}, {"iter_fn": t_iter()}),
}


def mesh(d):
    return ts.lane_mesh(devices=["cpu"] * d)


def assert_solutions_bitwise(got, want):
    for f in dataclasses.fields(tt.Solution):
        assert_bitwise_equal(np_(getattr(got, f.name)),
                             np_(getattr(want, f.name)), f.name)


def assert_solution_matches_jax(got, want):
    np.testing.assert_array_equal(np_(got.iters), np.asarray(want.iters))
    np.testing.assert_array_equal(np_(got.feasible),
                                  np.asarray(want.feasible))
    assert_bitwise_equal(np_(got.aux), np.asarray(want.aux), "aux")
    for f in ("r", "psi", "sM", "sR"):
        assert_ulp_close(np_(getattr(got, f)), np.asarray(getattr(want, f)),
                         ulps=64, scale=np.asarray(want.r), err_msg=f)


# --------------------------------------------------------------------------
# Lane padding
# --------------------------------------------------------------------------

def test_padded_lane_count_matches_jax():
    for b, d in [(11, 8), (16, 8), (1, 8), (9, 1), (258, 3), (5, 4)]:
        assert ts.padded_lane_count(b, d) == js.padded_lane_count(b, d)
    for b, d in [(0, 8), (3, 0)]:
        with pytest.raises(ValueError):
            ts.padded_lane_count(b, d)


def test_pad_batch_lanes_inert_and_matches_jax():
    bj, _ = batch_pair(40, RAGGED)
    bt = to_port_batch(bj)             # the same leaves, so padding is bitwise
    padded = ts.pad_batch_lanes(bt, 16)
    want = js.pad_batch_lanes(bj, 16)
    for f, leaf in leaves(want.scenarios).items():
        assert_bitwise_equal(np_(getattr(padded.scenarios, f)), leaf, f)
    np.testing.assert_array_equal(np_(padded.mask), np.asarray(want.mask))
    np.testing.assert_array_equal(np_(padded.n_classes),
                                  np.asarray(want.n_classes))
    # solving the padded batch leaves the real lanes bit for bit, and the
    # inert lanes take one iteration to the empty allocation
    ref, sol = tg.solve_distributed_batch(bt), tg.solve_distributed_batch(
        padded)
    assert_solutions_bitwise(tt.Solution(**{
        f.name: getattr(sol, f.name)[:11]
        for f in dataclasses.fields(tt.Solution)}), ref)
    assert (np_(sol.r[11:]) == 0.0).all() and np_(sol.feasible[11:]).all()
    assert (np_(sol.iters[11:]) == 1).all()
    assert ts.pad_batch_lanes(bt, bt.batch_size) is bt
    with pytest.raises(ValueError):
        ts.pad_batch_lanes(bt, bt.batch_size - 1)


def test_pad_warm_start_and_window_state_match_jax():
    bj, bt = batch_pair(41, (4, 7, 5))
    init_j = jg.cold_start(bj)
    init_t = convert.warm_start_from_numpy(leaves(init_j), device="cpu")
    padded = ts.pad_warm_start(init_t, 8)
    for f, leaf in leaves(js.pad_warm_start(init_j, 8)).items():
        assert_bitwise_equal(np_(getattr(padded, f)), leaf, f)
    assert not np_(padded.active[3:]).any()             # pad lanes frozen
    assert ts.pad_warm_start(init_t, 3) is init_t
    wj, _ = window_pair(42, (2, 3, 4))
    je.CapacityEngine().open_window(wj).solve()
    st = convert.window_state_from_numpy(leaves(wj.state), device="cpu")
    got, want = ts.pad_window_state(st, 8), js.pad_window_state(wj.state, 8)
    for f, leaf in leaves(want).items():
        assert_bitwise_equal(np_(getattr(got, f)), leaf, f)
    assert ts.pad_window_state(st, 3) is st
    with pytest.raises(ValueError):
        ts.pad_window_state(st, 2)


def test_lane_mesh_validation():
    m = mesh(3)
    assert m.devices.shape == (3,) and m.axis_names == ("lanes",)
    assert all(d == torch.device("cpu") for d in m.devices)
    assert m == mesh(3) and hash(m) == hash(mesh(3)) and m != mesh(2)
    with pytest.raises(ValueError):
        ts.lane_mesh(0)
    with pytest.raises(ValueError):
        ts.lane_mesh(devices=[])
    if not torch.cuda.is_available():
        # the default mesh is the card's: no fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.lane_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.lane_mesh(devices=["cuda:0"])
    flat = ts.LaneMesh(m.devices.reshape(1, 3), ("a", "b"))
    _, bt = batch_pair(43, (3, 4))
    with pytest.raises(ValueError, match="1-D mesh"):
        ts.solve_sharded_batch(bt, flat)
    with pytest.raises(ValueError, match="1-D mesh"):
        ts.lane_sharding(flat)
    # a solve never moves the batch to a mesh on another device
    with pytest.raises(ValueError, match="mesh starts on"):
        ts.solve_sharded_batch(bt, ts.lane_mesh(devices=["meta"]))
    fp = te.SolverConfig(mesh=m).fingerprint()
    assert fp == je.SolverConfig(mesh=js.lane_mesh(3)).fingerprint()
    assert fp.endswith("|mesh=3:lanes")


def test_shard_batch_keeps_the_padded_lanes():
    _, bt = batch_pair(44, (5, 9, 7, 3, 6))
    placed = ts.shard_batch(bt, mesh(4))
    assert placed.batch_size == 8 and not np_(placed.mask[5:]).any()
    sol = tg.solve_distributed_batch(placed, mesh=mesh(4))
    assert sol.r.shape == (8, bt.n_max)
    assert_solutions_bitwise(
        tt.Solution(**{f.name: getattr(sol, f.name)[:5]
                       for f in dataclasses.fields(tt.Solution)}),
        tg.solve_distributed_batch(bt))


# --------------------------------------------------------------------------
# Sharded == unsharded (port, bitwise) and sharded == JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_sharded_equals_unsharded_bitwise(d):
    """Ragged class counts and 11 lanes: every configuration's sharded
    solve equals its unsharded solve bit for bit, padding trimmed."""
    _, bt = batch_pair(45, RAGGED)
    for _, kt in CONFIGS.values():
        ref = tg.solve_distributed_batch(bt, **kt)
        sol = tg.solve_distributed_batch(bt, mesh=mesh(d), **kt)
        assert sol.r.shape == ref.r.shape
        assert_solutions_bitwise(sol, ref)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_matches_jax(name):
    """The port's ``solve_sharded_batch`` on 3 CPU shards against JAX's on
    three host devices, each configuration."""
    kj, kt = CONFIGS[name]
    bj, bt = batch_pair(46, RAGGED)
    want = js.solve_sharded_batch(bj, js.lane_mesh(3), **kj)
    got = ts.solve_sharded_batch(bt, mesh(3), **kt)
    assert_solution_matches_jax(got, want)


def test_sharded_warm_start_parity():
    """A mixed frozen / active warm start: frozen lanes pass through, active
    lanes iterate the cold trajectory, sharded as unsharded (bitwise) and
    as JAX's sharded solve of the same init."""
    bj, bt = batch_pair(47, (6, 11, 4, 9, 14, 3))
    base = tg.solve_distributed_batch(bt)
    cold = tg.cold_start(bt)
    frozen = torch.tensor([True, False, True, False, False, True])
    init = cold._replace(
        r=torch.where(frozen[:, None], base.r, cold.r),
        rho=torch.where(frozen, base.aux, cold.rho),
        lane_iters=torch.where(frozen, base.iters, cold.lane_iters),
        active=~frozen)
    ref = tg.solve_distributed_batch(bt, init=init)
    sol = tg.solve_distributed_batch(bt, init=init, mesh=mesh(4))
    assert_solutions_bitwise(sol, ref)
    for b in (0, 2, 5):
        assert_bitwise_equal(np_(sol.r[b]), np_(base.r[b]))
        assert int(sol.iters[b]) == int(base.iters[b])
    init_j = jg.BatchWarmStart(**{k: np.asarray(v) for k, v in
                                  convert.to_numpy(init)._asdict().items()})
    want = js.solve_sharded_batch(bj, js.lane_mesh(4), init=init_j)
    assert_solution_matches_jax(sol, want)


def test_engine_solve_with_mesh_matches_unsharded_and_jax():
    bj, bt = batch_pair(48, (5, 17, 9, 12, 3))
    ref = te.CapacityEngine(device="cpu").solve(bt)
    got = te.CapacityEngine(te.SolverConfig(mesh=mesh(4)),
                            device="cpu").solve(bt)
    assert_solutions_bitwise(got.fractional, ref.fractional)
    for f in ("r", "sM", "sR", "h"):
        assert_bitwise_equal(np_(getattr(got.integer, f)),
                             np_(getattr(ref.integer, f)), f)
    want = je.CapacityEngine(je.SolverConfig(mesh=js.lane_mesh(4))).solve(bj)
    assert_solution_matches_jax(got.fractional, want.fractional)
    for f in ("r", "sM", "sR", "h"):
        np.testing.assert_array_equal(np_(getattr(got.integer, f)),
                                      np.asarray(getattr(want.integer, f)))


# --------------------------------------------------------------------------
# Window re-solves under a mesh
# --------------------------------------------------------------------------

def window_engines(mesh_t, mesh_j=None):
    pol_t = te.Policies(rounding=te.RoundingPolicy(False))
    eng_t = te.CapacityEngine(te.SolverConfig(mesh=mesh_t), pol_t,
                              device="cpu")
    eng_j = je.CapacityEngine(je.SolverConfig(mesh=mesh_j),
                              je.Policies(rounding=je.RoundingPolicy(False)))
    return eng_t, eng_j


def test_dirty_lane_resolve_under_mesh():
    """Only the dirtied lane iterates; the sharded window solve equals the
    unsharded one and a cold re-solve of the window, bit for bit."""
    _, w_mesh = window_pair(49, (5, 8, 3, 6, 4))
    _, w_ref = window_pair(49, (5, 8, 3, 6, 4))
    eng_m, _ = window_engines(mesh(3))
    eng_r, _ = window_engines(None)
    first_m, first_r = eng_m._solve_window(w_mesh), eng_r._solve_window(w_ref)
    assert first_m.resolved.all()
    assert_solutions_bitwise(first_m.fractional, first_r.fractional)
    params = {k: float(v[0])
              for k, v in table5_raw(np.random.default_rng(7), 1).items()}
    w_mesh.arrive(2, **params)
    w_ref.arrive(2, **params)
    res_m, res_r = eng_m._solve_window(w_mesh), eng_r._solve_window(w_ref)
    np.testing.assert_array_equal(res_m.resolved,
                                  [False, False, True, False, False])
    assert_solutions_bitwise(res_m.fractional, res_r.fractional)
    for b in (0, 1, 3, 4):
        assert_bitwise_equal(np_(res_m.fractional.r[b]),
                             np_(first_m.fractional.r[b]))
    assert_solutions_bitwise(res_m.fractional,
                             tg.solve_distributed_batch(w_mesh.batch))


def test_random_trace_under_mesh_matches_unsharded_and_jax():
    """Event by event, a 4-shard session lands on the unsharded session's
    equilibria bit for bit and on JAX's 4-device session within the window
    tolerances, through growth past n_max."""
    wj, w_mesh = window_pair(50, (5, 8, 3, 6, 4), n_max=8)
    _, w_ref = window_pair(50, (5, 8, 3, 6, 4), n_max=8)
    eng_m, eng_j = window_engines(mesh(4), js.lane_mesh(4))
    eng_r, _ = window_engines(None)
    trace = jstream.sample_event_trace(51, wj, 25)
    events = port_events(trace)
    for i in range(len(trace) + 1):
        if i:
            wj.apply(trace[i - 1])
            w_mesh.apply(events[i - 1])
            w_ref.apply(events[i - 1])
        rm, rr = eng_m._solve_window(w_mesh), eng_r._solve_window(w_ref)
        rj = eng_j._solve_window(wj)
        np.testing.assert_array_equal(rm.resolved, rr.resolved)
        assert_solutions_bitwise(rm.fractional, rr.fractional)
        np.testing.assert_array_equal(rm.resolved, rj.resolved)
        np.testing.assert_array_equal(np_(rm.iters), np.asarray(rj.iters))
        for f in ("r", "aux", "total"):
            want = np.asarray(getattr(rj.fractional, f), np.float64)
            scale = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(np_(getattr(rm.fractional, f)), want,
                                       rtol=1e-12, atol=1e-12 * scale)
    assert w_mesh.n_max == wj.n_max > 8
