"""Device-resident window sessions of the port (``residency="resident"``).

A resident session keeps its window padded on a lane mesh across flushes:
events write into the padded tensors, the warm start is built there, and
the padded solution is committed.  Its flush reports must equal the
round-trip session's bit for bit (both on the same 4-shard CPU mesh)
through random traces, coalesced epochs, growth past ``n_max``,
departures and compaction, lanes added and removed across the mesh
padding, ``release_resident`` and aborted epochs; no report returned
earlier may change later.  One trace is also held, flush by flush, to the
JAX package's resident session: ``resolved``, iterations, feasibility and
masks exact, r / price / total within 1e-12 relative, as in
``tests/test_torch_window.py``; the window's leaves within 16 ULPs on the
six sqrt-derived fields (ROADMAP Queue 3 item 4), bitwise elsewhere.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal
from _torch_parity import (leaves, np_, port_events, table5_raw,
                           window_pair)
from repro.core import engine as je
from repro.core import sharding as js
from repro.core import streaming as jstream
from repro_torch.core import engine as te
from repro_torch.core import sharding as ts
from repro_torch.core import streaming as tstream
from repro_torch.core import types as tt

B, N, N_MAX, MESH_D = 5, 4, 8, 4
FIELDS = [f.name for f in dataclasses.fields(tt.Scenario)]
SQRT_DERIVED = ("xiM", "xiR", "K", "r_up", "r_low", "p")


def scenario(rng, n=N):
    raw = table5_raw(rng, n)
    scn = tt.derive(**{k: torch.as_tensor(v) for k, v in raw.items()},
                    R=0.0, rho_bar=float(rng.uniform(1.0, 1.6)), device="cpu")
    return scn.replace(R=1.3 * scn.r_up.sum())


def make_window(seed=0, *, lanes=B, n_max=N_MAX):
    rng = np.random.default_rng(seed)
    return tstream.AdmissionWindow([scenario(rng) for _ in range(lanes)],
                                   n_max=n_max)


def class_params(seed):
    raw = table5_raw(np.random.default_rng(seed), 1)
    return {k: float(v[0]) for k, v in raw.items()}


def make_session(residency, *, flush_k=1, seed=0, n_max=N_MAX, mesh=None):
    eng = te.CapacityEngine(
        te.SolverConfig(mesh=mesh or ts.lane_mesh(devices=["cpu"] * MESH_D),
                        residency=residency),
        te.Policies(flush=tstream.FlushPolicy(max_events=flush_k),
                    rounding=te.RoundingPolicy(False)),
        device="cpu")
    return eng.open_window(make_window(seed, n_max=n_max))


def session_pair(**kw):
    """(resident, round-trip) sessions over identically drawn windows."""
    return make_session("resident", **kw), make_session("round-trip", **kw)


def trace(seed, window_seed, n):
    return tstream.sample_event_trace(seed, make_window(window_seed), n)


def assert_reports_bitequal(a, b):
    for f in dataclasses.fields(tt.Solution):
        assert_bitwise_equal(np_(getattr(a.fractional, f.name)),
                             np_(getattr(b.fractional, f.name)), f.name)
    np.testing.assert_array_equal(np_(a.iters), np_(b.iters))
    np.testing.assert_array_equal(a.resolved, b.resolved)
    np.testing.assert_array_equal(np_(a.mask), np_(b.mask))
    np.testing.assert_array_equal(np_(a.n_classes), np_(b.n_classes))


def window_state_equal(w_res, w_ref):
    """The resident window's logical state equals the host window's."""
    np.testing.assert_array_equal(w_res._mask, w_ref._mask)
    assert w_res._raw == w_ref._raw
    np.testing.assert_array_equal(w_res.dirty, w_ref.dirty)
    a, b = w_res.batch, w_ref.batch
    for f in FIELDS:
        assert_bitwise_equal(np_(getattr(a.scenarios, f)),
                             np_(getattr(b.scenarios, f)), f)
    np.testing.assert_array_equal(np_(a.mask), np_(b.mask))


def assert_mask_mirror(window):
    pad_b = window._mask_dev.shape[0]
    assert pad_b == ts.padded_lane_count(window.batch_size, MESH_D)
    full = np.zeros((pad_b, window.n_max), bool)
    full[:window.batch_size] = window._mask
    np.testing.assert_array_equal(np_(window._mask_dev), full)


# --------------------------------------------------------------------------
# Resident == round-trip, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [11, 23])
def test_random_trace_bitequal(seed):
    """A flush after every event of a random trace (growth included)."""
    s_res, s_rt = session_pair(seed=seed)
    assert_reports_bitequal(s_res.solve(), s_rt.solve())
    assert s_res.window.is_resident and not s_rt.window.is_resident
    for ev in trace(seed + 1, seed, 20):
        s_res.window.apply(ev)
        s_rt.window.apply(ev)
        assert_reports_bitequal(s_res.solve(), s_rt.solve())
    assert s_res.window.is_resident
    assert_mask_mirror(s_res.window)


def test_coalesced_epochs_bitequal():
    s_res, s_rt = session_pair(flush_k=4, seed=3)
    s_res.solve(), s_rt.solve()
    events = trace(7, 3, 24)
    got, want = list(s_res.stream(events)), list(s_rt.stream(events))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert_reports_bitequal(a, b)


def test_growth_past_n_max():
    """Arrivals into a full lane grow the padded rows, padding lanes
    included, and the mask mirror with them."""
    s_res, s_rt = session_pair(seed=5, n_max=N)      # no headroom
    s_res.solve(), s_rt.solve()
    for i in range(3):                               # two growths
        params = class_params(100 + i)
        assert s_res.window.arrive(1, **params) == s_rt.window.arrive(
            1, **params)
        assert_reports_bitequal(s_res.solve(), s_rt.solve())
    w = s_res.window
    assert w.n_max == s_rt.window.n_max > N and w.is_resident
    assert w._scn.A.shape == (8, w.n_max) and w.state.r.shape == (8, w.n_max)
    # the padding lanes' grown columns are the inert values
    assert (np_(w._scn.rho_up[B:]) == 1.0).all()
    assert_mask_mirror(w)


def test_departures_and_compaction_slot_map():
    s_res, s_rt = session_pair(seed=9)
    s_res.solve(), s_rt.solve()
    for lane, slot in [(0, 1), (2, 0), (2, 2), (4, 3)]:
        s_res.window.depart(lane, slot)
        s_rt.window.depart(lane, slot)
    assert_reports_bitequal(s_res.solve(), s_rt.solve())
    m_res, m_rt = s_res.compact(), s_rt.compact()
    np.testing.assert_array_equal(m_res, m_rt)
    assert s_res.window.is_resident                  # re-established
    assert s_res.window.n_max == s_rt.window.n_max < N_MAX
    assert_reports_bitequal(s_res.solve(), s_rt.solve())
    ev = tt.ClassArrival(lane=2, params=class_params(77))
    s_res.window.apply(ev), s_rt.window.apply(ev)
    assert_reports_bitequal(s_res.solve(), s_rt.solve())
    assert_mask_mirror(s_res.window)


def test_lane_count_crossing_mesh_padding():
    """B 5 -> 9 -> 7 on a 4-shard mesh: the padded count goes 8 -> 12 -> 8,
    residency is dropped and re-established inside each geometry change."""
    s_res, s_rt = session_pair(seed=13)
    s_res.solve(), s_rt.solve()
    rng = np.random.default_rng(500)
    for _ in range(4):
        scn = scenario(rng)
        assert s_res.window.add_lane(scn) == s_rt.window.add_lane(scn)
        assert_reports_bitequal(s_res.solve(), s_rt.solve())
    assert s_res.window.batch_size == 9
    assert s_res.window._scn.A.shape[0] == 12
    for lane in (6, 0):
        s_res.window.remove_lane(lane)
        s_rt.window.remove_lane(lane)
        assert_reports_bitequal(s_res.solve(), s_rt.solve())
    assert s_res.window.is_resident and s_res.window._scn.A.shape[0] == 8
    empty = s_res.window.add_lane(R=50.0, rho_bar=1.2)
    assert empty == s_rt.window.add_lane(R=50.0, rho_bar=1.2)
    assert_reports_bitequal(s_res.solve(), s_rt.solve())


def test_release_resident_indistinguishable():
    s_res, s_rt = session_pair(seed=17)
    s_res.solve(), s_rt.solve()
    for ev in trace(18, 17, 6):
        s_res.window.apply(ev), s_rt.window.apply(ev)
    s_res.window.release_resident()
    w = s_res.window
    assert not w.is_resident and w._mask_dev is None
    window_state_equal(w, s_rt.window)
    for f in FIELDS:                   # leaf by leaf, no padding lanes left
        assert_bitwise_equal(np_(getattr(w._scn, f)),
                             np_(getattr(s_rt.window._scn, f)), f)
    eng = te.CapacityEngine(
        te.SolverConfig(mesh=ts.lane_mesh(devices=["cpu"] * MESH_D)),
        te.Policies(rounding=te.RoundingPolicy(False)), device="cpu")
    assert_reports_bitequal(eng.open_window(w).solve(), s_rt.solve())


def test_migrating_to_another_mesh_and_one_shard():
    """make_resident with another mesh migrates the window; a one-shard
    mesh keeps no padding."""
    s_res, s_rt = session_pair(seed=19)
    s_res.solve(), s_rt.solve()
    one = ts.lane_mesh(devices=["cpu"])
    s_res.window.make_resident(one)
    assert s_res.window._scn.A.shape[0] == B
    eng = te.CapacityEngine(te.SolverConfig(mesh=one, residency="resident"),
                            te.Policies(rounding=te.RoundingPolicy(False)),
                            device="cpu")
    sess = eng.open_window(s_res.window)
    for ev in trace(20, 19, 6):
        sess.window.apply(ev), s_rt.window.apply(ev)
        assert_reports_bitequal(sess.solve(), s_rt.solve())
    with pytest.raises(ValueError, match="different mesh"):
        s_res.solve()                                # 4-shard config


# --------------------------------------------------------------------------
# Abort, discard and drain on a resident session
# --------------------------------------------------------------------------

def test_abort_discard_pending_then_reuse():
    s_res, s_rt = session_pair(flush_k=3, seed=21)
    s_res.solve(), s_rt.solve()
    events = trace(22, 21, 10)
    for ev in events[:6]:
        s_res.apply(ev), s_rt.apply(ev)
    s_res.apply(events[6]), s_rt.apply(events[6])
    assert s_res.discard_pending() == s_rt.discard_pending() == (events[6],)
    window_state_equal(s_res.window, s_rt.window)
    assert_reports_bitequal(s_res.solve(), s_rt.solve())
    for ev in events[7:]:
        a, b = s_res.apply(ev), s_rt.apply(ev)
        assert (a is None) == (b is None)
        if a is not None:
            assert_reports_bitequal(a, b)


def test_abort_invalid_event_keeps_residency_consistent():
    s_res, s_rt = session_pair(seed=25)
    s_res.solve(), s_rt.solve()
    for w in (s_res.window, s_rt.window):
        with pytest.raises(ValueError):
            w.arrive(0, A=1.0)
        with pytest.raises(IndexError):
            w.apply_epoch([tt.ClassDeparture(lane=0, slot=N_MAX - 1)])
    window_state_equal(s_res.window, s_rt.window)
    assert_mask_mirror(s_res.window)
    assert_reports_bitequal(s_res.solve(), s_rt.solve())


def test_drain_folds_without_solving():
    s_res, s_rt = session_pair(flush_k=100, seed=29)
    s_res.solve(), s_rt.solve()
    for ev in trace(30, 29, 8):
        assert s_res.apply(ev) is None and s_rt.apply(ev) is None
    assert s_res.drain() == s_rt.drain()
    window_state_equal(s_res.window, s_rt.window)
    assert_mask_mirror(s_res.window)
    assert_reports_bitequal(s_res.solve(), s_rt.solve())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resident_epochs_equal_host_epochs(seed):
    """Epochs of three events folded into a resident window leave its
    logical leaves and mask mirror equal to a host window's (the
    reference's hypothesis property, at fixed seeds)."""
    w_res, w_host = make_window(seed), make_window(seed)
    w_res.make_resident(ts.lane_mesh(devices=["cpu"] * MESH_D))
    events = trace(seed + 1, seed, 12)
    for i in range(0, len(events), 3):
        epoch = events[i:i + 3]
        assert w_res.apply_epoch(epoch) == w_host.apply_epoch(epoch)
    window_state_equal(w_res, w_host)
    assert_mask_mirror(w_res)


@pytest.mark.parametrize("seed", [3, 4])
def test_returned_reports_never_change(seed):
    """No report returned earlier may change as later events and flushes
    update the window's state (nothing writes in place)."""
    s_res, _ = session_pair(seed=seed)
    reports = [s_res.solve()]
    for ev in trace(seed + 1, seed, 8):
        s_res.window.apply(ev)
        reports.append(s_res.solve())
    snaps = [{f.name: np_(getattr(r.fractional, f.name)).copy()
              for f in dataclasses.fields(tt.Solution)} for r in reports]
    for ev in trace(seed + 2, seed, 8):
        s_res.window.apply(ev)
        s_res.solve()
    s_res.compact()
    s_res.window.add_lane(R=40.0, rho_bar=1.1)
    s_res.solve()
    for rep, snap in zip(reports, snaps):
        for name, want in snap.items():
            assert_bitwise_equal(np_(getattr(rep.fractional, name)), want,
                                 name)


# --------------------------------------------------------------------------
# Engine plumbing and guard rails
# --------------------------------------------------------------------------

def test_residency_config_validation():
    with pytest.raises(ValueError, match="needs a mesh"):
        te.CapacityEngine(te.SolverConfig(residency="resident"),
                          device="cpu")
    with pytest.raises(ValueError, match="unknown residency"):
        te.CapacityEngine(te.SolverConfig(residency="wat"), device="cpu")
    m = ts.lane_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="f32_checked"):
        te.CapacityEngine(te.SolverConfig(mesh=m, residency="resident",
                                          dtype_policy="f32_checked"),
                          device="cpu")
    assert "residency" not in te.SolverConfig().fingerprint()
    fp = te.SolverConfig(mesh=m, residency="resident").fingerprint()
    assert fp == je.SolverConfig(mesh=js.lane_mesh(2),
                                 residency="resident").fingerprint()
    assert fp.endswith("|mesh=2:lanes|residency=resident")


def test_host_warm_start_refused_while_resident():
    s_res, _ = session_pair(seed=33)
    s_res.solve()
    with pytest.raises(RuntimeError, match="resident_warm_start"):
        s_res.window.warm_start()
    s_res.window.release_resident()
    assert s_res.window.warm_start() is not None
    with pytest.raises(RuntimeError, match="not device-resident"):
        s_res.window.resident_batch()


def test_make_resident_refuses_bad_meshes():
    w = make_window(37)
    cpu = ts.lane_mesh(devices=["cpu"])
    with pytest.raises(ValueError, match="1-D mesh"):
        w.make_resident(ts.LaneMesh(cpu.devices.reshape(1, 1), ("a", "b")))
    # a window never moves to a mesh on another device
    with pytest.raises(ValueError, match="mesh starts on"):
        w.make_resident(ts.lane_mesh(devices=["meta"]))
    assert not w.is_resident


# --------------------------------------------------------------------------
# Against the JAX package's resident session
# --------------------------------------------------------------------------

def test_resident_session_matches_jax():
    """The same windows and trace through both packages' resident sessions
    on 4 shards, flushes of 4 events (growth past n_max included)."""
    wj, wt = window_pair(60, (8, 8, 7, 8, 6), n_max=8)
    pol = dict(flush={"max_events": 4})
    eng_j = je.CapacityEngine(
        je.SolverConfig(mesh=js.lane_mesh(MESH_D), residency="resident"),
        je.Policies(flush=jstream.FlushPolicy(**pol["flush"])))
    eng_t = te.CapacityEngine(
        te.SolverConfig(mesh=ts.lane_mesh(devices=["cpu"] * MESH_D),
                        residency="resident"),
        te.Policies(flush=tstream.FlushPolicy(**pol["flush"])), device="cpu")
    sj, st = eng_j.open_window(wj), eng_t.open_window(wt)
    events = jstream.sample_event_trace(61, wj, 24, p_arrive=0.7,
                                        p_depart=0.1)
    pairs = [(st.solve(), sj.solve())]
    pairs += zip(st.stream(port_events(events)), sj.stream(events))
    assert len(pairs) == 7 and wt.is_resident and wj.is_resident
    for rt, rj in pairs:
        np.testing.assert_array_equal(rt.resolved, rj.resolved)
        for f in ("iters", "feasible", "mask", "n_classes"):
            np.testing.assert_array_equal(np_(getattr(rt, f)),
                                          np.asarray(getattr(rj, f)))
        for f in ("r", "aux", "total"):
            want = np.asarray(getattr(rj.fractional, f), np.float64)
            scale = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(np_(getattr(rt.fractional, f)), want,
                                       rtol=1e-12, atol=1e-12 * scale,
                                       err_msg=f)
        for f in ("r", "sM", "sR", "h"):
            np.testing.assert_array_equal(np_(getattr(rt.integer, f)),
                                          np.asarray(getattr(rj.integer, f)))
    assert wt.n_max == wj.n_max > 8
    # the padded resident leaves, padding lanes included
    assert wt._scn.A.shape == tuple(wj._scn.A.shape)
    for f, want in leaves(wj._scn).items():
        got = np_(getattr(wt._scn, f))
        if f in SQRT_DERIVED:
            np.testing.assert_allclose(got, want, atol=0, err_msg=f,
                                       rtol=16 * np.finfo(want.dtype).eps)
        else:
            assert_bitwise_equal(got, want, f)
    np.testing.assert_array_equal(np_(wt._mask_dev),
                                  np.asarray(wj._mask_dev))
