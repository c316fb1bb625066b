"""The port's deprecated facades (``repro_torch.core.allocator``).

Each facade warns (``DeprecationWarning``, asserted with ``pytest.warns``)
and returns bit for bit what its engine call returns; its engine runs on
its input's device.  Against the JAX package's facades on the same inputs
the engine tolerances hold (``tests/test_torch_engine.py``: iterations,
prices, feasibility and integer results exact, fractional r within 64
ULPs of its scale) and, for windows, those of
``tests/test_torch_window.py`` (1e-12 relative).  ``EventEpoch.flush``
goes through ``engine._legacy_solve_window`` and warns about nothing.
"""
import dataclasses
import warnings

import numpy as np
import pytest

from _tolerance import assert_bitwise_equal, assert_ulp_close
from _torch_parity import (batch_pair, np_, port_events, scenario_pairs,
                           window_pair)
from repro.core import allocator as ja
from repro.core import sharding as js
from repro.core import streaming as jstream
from repro.kernels.gnep_sweep.ops import make_batched_sweep_fn as j_sweep
from repro_torch.core import allocator as ta
from repro_torch.core import engine as te
from repro_torch.core import sharding as ts
from repro_torch.core import streaming as tstream
from repro_torch.core import types as tt
from repro_torch.kernels.gnep_sweep.ops import make_batched_sweep_fn as t_sweep

PREFIX = (r"repro_torch\.core\.allocator\.\w+ is deprecated; use "
          r"repro_torch\.core\.engine\.CapacityEngine")


def port_warns():
    return pytest.warns(DeprecationWarning, match=PREFIX)


def jax_warns():
    return pytest.warns(DeprecationWarning, match=r"repro\.core\.allocator")


def assert_reports_bitequal(a, b):
    assert type(a) is type(b) and a.method == b.method
    for f in dataclasses.fields(tt.Solution):
        assert_bitwise_equal(np_(getattr(a.fractional, f.name)),
                             np_(getattr(b.fractional, f.name)), f.name)
    assert (a.integer is None) == (b.integer is None)
    if a.integer is not None:
        for f in ("r", "sM", "sR", "h", "psi", "total"):
            assert_bitwise_equal(np_(getattr(a.integer, f)),
                                 np_(getattr(b.integer, f)), f)
    np.testing.assert_array_equal(np_(a.iters), np_(b.iters))
    for f in ("mask", "n_classes", "feasible", "resolved", "slot_map",
              "centralized_gap"):
        fa, fb = getattr(a, f, None), getattr(b, f, None)
        assert (fa is None) == (fb is None)
        if fa is not None:
            np.testing.assert_array_equal(np_(fa), np_(fb))


def assert_matches_jax(got, want, rel=None):
    np.testing.assert_array_equal(np_(got.iters), np.asarray(want.iters))
    if rel is None:
        assert_bitwise_equal(np_(got.fractional.aux),
                             np.asarray(want.fractional.aux), "aux")
        assert_ulp_close(np_(got.fractional.r),
                         np.asarray(want.fractional.r), ulps=64,
                         scale=np.asarray(want.fractional.r))
    else:
        for f in ("r", "aux", "total"):
            w = np.asarray(getattr(want.fractional, f), np.float64)
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(np_(getattr(got.fractional, f)), w,
                                       rtol=rel, atol=rel * scale)
    if want.integer is not None:
        for f in ("r", "sM", "sR", "h"):
            np.testing.assert_array_equal(np_(getattr(got.integer, f)),
                                          np.asarray(getattr(want.integer,
                                                             f)))


def test_legacy_result_types_are_report_aliases():
    assert ta.AllocationResult is te.SolveReport
    assert ta.BatchAllocationResult is te.BatchSolveReport
    assert ta.StreamingResult is te.WindowSolveReport
    assert ta.InfeasibleError is te.InfeasibleError


@pytest.mark.parametrize("method", ["distributed", "centralized",
                                    "distributed-python"])
def test_solve_facade_bitequal_and_matches_jax(method):
    sj, st = scenario_pairs(70, ns=(9,))
    want = te.CapacityEngine(te.SolverConfig(eps_bar=0.05, max_iters=100),
                             device="cpu").solve(st[0], method=method)
    with port_warns():
        got = ta.solve(st[0], method, eps_bar=0.05, max_iters=100)
    assert_reports_bitequal(got, want)
    assert got.fractional.r.device == st[0].A.device
    with jax_warns():
        ref = ja.solve(sj[0], method, eps_bar=0.05, max_iters=100)
    assert got.iters == ref.iters
    assert_ulp_close(np_(got.fractional.r), np.asarray(ref.fractional.r),
                     ulps=64, scale=np.asarray(ref.fractional.r))
    for f in ("r", "sM", "sR", "h"):
        np.testing.assert_array_equal(np_(getattr(got.integer, f)),
                                      np.asarray(getattr(ref.integer, f)))


def test_solve_facade_infeasible_and_no_rounding():
    _, bad = scenario_pairs(71, ns=(8,), capacity_factor=0.5)
    with port_warns(), pytest.raises(te.InfeasibleError):
        ta.solve(bad[0], "centralized")
    _, good = scenario_pairs(72, ns=(7,))
    want = te.CapacityEngine(policies=te.Policies(
        rounding=te.RoundingPolicy(False)), device="cpu").solve(good[0])
    with port_warns():
        got = ta.solve(good[0], integer=False)
    assert got.integer is None
    assert_reports_bitequal(got, want)


@pytest.mark.parametrize("form", ["batch", "list", "sweep", "mesh"])
def test_solve_batch_facade_bitequal_and_matches_jax(form):
    """A batch, a loose scenario list, the sweep plug-in and a 3-shard mesh:
    each bit for bit its engine call, and within the engine tolerances of
    the JAX facade's same call."""
    sj, st = scenario_pairs(73, ns=(5, 17, 9, 12))
    bj, bt = batch_pair(73, (5, 17, 9, 12))
    kw_t, kw_j = {}, {}
    if form == "sweep":
        kw_t, kw_j = {"sweep_fn": t_sweep()}, {"sweep_fn": j_sweep()}
    elif form == "mesh":
        kw_t = {"mesh": ts.lane_mesh(devices=["cpu"] * 3)}
        kw_j = {"mesh": js.lane_mesh(3)}
    prob_t, prob_j = (st, sj) if form == "list" else (bt, bj)
    want = te.CapacityEngine(te.SolverConfig(**kw_t),
                             device="cpu").solve(prob_t)
    with port_warns():
        got = ta.solve_batch(prob_t, **kw_t)
    assert_reports_bitequal(got, want)
    with jax_warns():
        ref = ja.solve_batch(prob_j, **kw_j)
    assert_matches_jax(got, ref)


def test_solve_batch_facade_check_feasible_and_knobs():
    _, st = scenario_pairs(74, ns=(8, 8))
    _, bad = scenario_pairs(75, ns=(8,), capacity_factor=0.5)
    lanes = [st[0], bad[0]]
    with port_warns(), pytest.raises(te.InfeasibleError, match=r"\[1\]"):
        ta.solve_batch(lanes)
    eng = te.CapacityEngine(
        te.SolverConfig(eps_bar=0.06, lam=0.04, max_iters=50),
        te.Policies(rounding=te.RoundingPolicy(False)), device="cpu")
    want = eng.solve(lanes, check_feasible=False)
    with port_warns():
        got = ta.solve_batch(lanes, eps_bar=0.06, lam=0.04, max_iters=50,
                             integer=False, check_feasible=False)
    assert_reports_bitequal(got, want)
    assert not bool(got.feasible[1])


def test_solve_streaming_facade_bitequal_and_matches_jax():
    """Cold solve, an arrival, a warm re-solve with the cross-check on a
    3-shard mesh: facade and session bit for bit at each step, and the JAX
    facade's reports within the window tolerances."""
    wj, w_shim = window_pair(76, (5, 8, 3, 6))
    _, w_eng = window_pair(76, (5, 8, 3, 6))
    mesh = ts.lane_mesh(devices=["cpu"] * 3)
    sess = te.CapacityEngine(
        te.SolverConfig(mesh=mesh),
        te.Policies(rounding=te.RoundingPolicy(False),
                    cross_check=te.CrossCheckPolicy(True)),
        device="cpu").open_window(w_eng)
    ev = jstream.sample_event_trace(77, wj, 1, p_arrive=1.0)
    for step in range(2):
        if step:
            wj.apply(ev[0])
            w_shim.apply(port_events(ev)[0])
            w_eng.apply(port_events(ev)[0])
        with port_warns():
            got = ta.solve_streaming(w_shim, integer=False, mesh=mesh,
                                     cross_check=True)
        assert_reports_bitequal(got, sess.solve())
        with jax_warns():
            ref = ja.solve_streaming(wj, integer=False, cross_check=True,
                                     mesh=js.lane_mesh(3))
        np.testing.assert_array_equal(got.resolved, ref.resolved)
        assert_matches_jax(got, ref, rel=1e-12)
        np.testing.assert_allclose(np_(got.centralized_gap),
                                   np.asarray(ref.centralized_gap), rtol=0,
                                   atol=1e-9)
    assert got.resolved.sum() == 1


def test_solve_coalesced_facade_bitequal_and_matches_jax():
    wj, w_shim = window_pair(78, (5, 8, 3, 6), n_max=9)
    _, w_eng = window_pair(78, (5, 8, 3, 6), n_max=9)
    events = jstream.sample_event_trace(79, wj, 14)
    eng = te.CapacityEngine(
        policies=te.Policies(flush=tstream.FlushPolicy(max_events=5),
                             rounding=te.RoundingPolicy(False)),
        device="cpu")
    want = list(eng.open_window(w_eng).stream(port_events(events)))
    with port_warns():
        gen = ta.solve_coalesced(w_shim, port_events(events),
                                 policy=tstream.FlushPolicy(max_events=5),
                                 integer=False)
    got = list(gen)
    with jax_warns():
        ref = list(ja.solve_coalesced(
            wj, events, policy=jstream.FlushPolicy(max_events=5),
            integer=False))
    assert len(got) == len(want) == len(ref) == 3    # 5 + 5 + trailing 4
    for g, w, r in zip(got, want, ref):
        assert_reports_bitequal(g, w)
        np.testing.assert_array_equal(g.resolved, r.resolved)
        assert_matches_jax(g, r, rel=1e-12)


def test_event_epoch_flush_is_the_legacy_adapter_and_never_warns():
    """``EventEpoch.flush`` equals ``_legacy_solve_window`` bit for bit, and
    no in-package path (engine solves, sessions, epochs) emits a
    DeprecationWarning."""
    _, w_epoch = window_pair(80, (5, 8, 3, 6), n_max=9)
    _, w_legacy = window_pair(80, (5, 8, 3, 6), n_max=9)
    events = tstream.sample_event_trace(81, w_epoch, 12)
    epoch = tstream.EventEpoch(w_epoch, tstream.FlushPolicy(max_events=4))
    mesh = ts.lane_mesh(devices=["cpu"] * 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        for i in range(0, len(events), 4):
            for ev in events[i:i + 4]:
                epoch.add(ev)
            got = epoch.flush(integer=False, mesh=mesh, cross_check=True)
            w_legacy.apply_epoch(events[i:i + 4])
            want = te._legacy_solve_window(w_legacy, integer=False,
                                           mesh=mesh, cross_check=True)
            assert_reports_bitequal(got, want)
        _, bt = batch_pair(82, (4, 6))
        te.CapacityEngine(device="cpu").solve(bt)
        sess = te.CapacityEngine(
            te.SolverConfig(mesh=mesh, residency="resident"),
            device="cpu").open_window(bt)
        list(sess.stream(tstream.sample_event_trace(83, sess.window, 6)))
    assert epoch.flushes == 3


def test_facade_engine_runs_on_the_input_device():
    """The facades build their engine on their input's device (the card by
    default, since the constructors default to it); a CPU input stays on the
    CPU."""
    _, bt = batch_pair(84, (3, 5))
    with port_warns():
        rep = ta.solve_batch(bt)
    assert rep.fractional.r.device == bt.device
    _, wt = window_pair(85, (3, 5))
    with port_warns():
        rep = ta.solve_streaming(wt)
    assert rep.fractional.r.device == wt.device
    with port_warns(), pytest.raises(TypeError):
        ta.solve_batch("not a problem")
