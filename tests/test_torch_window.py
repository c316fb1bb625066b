"""Parity of the port's window sessions (``CapacityEngine.open_window`` /
``WindowSession`` in ``repro_torch.core.engine``) with the JAX package.

Both sessions open on the same numpy-drawn instances; traces are drawn on
the JAX side and handed to the port as records.  Every flush's report is
compared: ``resolved``, iteration counts, feasibility, masks, ``slot_map``,
the integer solution and the flush counters exactly; the fractional
allocation and price within 1e-12 relative in f64 (1e-5 in f32) of their
scale, and the centralized gap within 1e-9 (1e-5 in f32).  Within the port, lanes a flush
did not resolve pass through bit for bit.
"""
import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal
from _torch_parity import (leaves, np_, port_events, scenario_pairs,
                           table5_raw, window_pair)
from repro.core import engine as je
from repro.core import streaming as js
from repro.core import types as jt
from repro.kernels.gnep_iter.ops import make_fused_iter_fn as j_iter
from repro.kernels.gnep_sweep.ops import make_batched_sweep_fn as j_sweep
from repro_torch import convert
from repro_torch.core import centralized as tc
from repro_torch.core import engine as te
from repro_torch.core import game as tg
from repro_torch.core import streaming as ts
from repro_torch.core import types as tt
from repro_torch.core.sharding import lane_mesh
from repro_torch.kernels.gnep_iter.ops import make_fused_iter_fn as t_iter
from repro_torch.kernels.gnep_sweep.ops import make_batched_sweep_fn as t_sweep
from repro_torch.utils import tree_map

CONFIGS = {
    "default": ({}, {}),
    "sweep": ({"sweep_fn": j_sweep()}, {"sweep_fn": t_sweep()}),
    "fused": ({"iter_fn": j_iter()}, {"iter_fn": t_iter()}),
    "f32_checked": ({"dtype_policy": "f32_checked[:2]"},) * 2,
}
NS = (5, 8, 3, 6)


def engines(config="default", **policies):
    """(JAX engine, port engine on the CPU) under one config and the same
    policies (``flush``, ``compaction`` as keyword dicts, ``cross_check``
    and ``rounding`` as flags)."""
    kj, kt = CONFIGS[config]

    def pols(mod, sm):
        return mod.Policies(
            flush=sm.FlushPolicy(**policies.get("flush", {})),
            compaction=mod.CompactionPolicy(**policies.get("compaction", {})),
            rounding=mod.RoundingPolicy(policies.get("rounding", True)),
            cross_check=mod.CrossCheckPolicy(policies.get("cross_check",
                                                          False)))
    return (je.CapacityEngine(je.SolverConfig(**kj), pols(je, js)),
            te.CapacityEngine(te.SolverConfig(**kt), pols(te, ts),
                              device="cpu"))


def assert_close(got, want, rel, label):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * scale, err_msg=label)


def assert_report_matches_jax(rt, rj, rel=1e-12):
    np.testing.assert_array_equal(rt.resolved, rj.resolved)
    for f in ("iters", "feasible", "mask", "n_classes"):
        np.testing.assert_array_equal(np_(getattr(rt, f)),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    if rj.slot_map is None:
        assert rt.slot_map is None
    else:
        np.testing.assert_array_equal(rt.slot_map, rj.slot_map)
    for f in ("r", "aux", "total"):
        assert_close(np_(getattr(rt.fractional, f)),
                     getattr(rj.fractional, f), rel, f)
    if rj.integer is not None:
        for f in ("r", "sM", "sR", "h"):
            np.testing.assert_array_equal(np_(getattr(rt.integer, f)),
                                          np.asarray(getattr(rj.integer, f)),
                                          err_msg=f"integer {f}")
    if rj.centralized_gap is not None:
        np.testing.assert_allclose(np_(rt.centralized_gap),
                                   np.asarray(rj.centralized_gap), rtol=0,
                                   atol=1e-9 if rel < 1e-6 else 1e-5)
    if rj.dtype_check is not None:
        assert rt.dtype_check["lanes"] == rj.dtype_check["lanes"]
        assert rt.dtype_check["max_rel"] <= rt.dtype_check["bound"]


def assert_passes_frozen_lanes_through(prev, rep):
    """Lanes ``rep`` did not resolve keep ``prev``'s r, price and iteration
    count bit for bit (over the columns both reports have)."""
    n = min(prev.mask.shape[1], rep.mask.shape[1])
    for b in np.flatnonzero(~rep.resolved):
        assert_bitwise_equal(np_(rep.fractional.r[b, :n]),
                             np_(prev.fractional.r[b, :n]))
        assert_bitwise_equal(np_(rep.fractional.aux[b]),
                             np_(prev.fractional.aux[b]))
        assert int(rep.iters[b]) == int(prev.iters[b])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_stream_reports_match_jax(config):
    """A 40-event JAX trace (arrivals, departures, edits, capacity changes,
    growth past n_max) through ``solve`` then ``stream``, cross-check on."""
    ej, et = engines(config, flush={"max_events": 6}, cross_check=True)
    sj, st = scenario_pairs(20, NS, 1.2)
    sess_j, sess_t = ej.open_window(sj, n_max=9), et.open_window(st, n_max=9)
    rel = 1e-5 if config == "f32_checked" else 1e-12
    assert sess_t.window._scn.A.dtype == (
        torch.float32 if config == "f32_checked" else torch.float64)
    first_t = sess_t.solve()
    assert_report_matches_jax(first_t, sess_j.solve(), rel)
    assert first_t.resolved.all()
    trace = js.sample_event_trace(21, sess_j.window, 40)
    reps_j = list(sess_j.stream(trace))
    reps_t = list(sess_t.stream(port_events(trace)))
    assert len(reps_t) == len(reps_j) == 7
    assert (sess_t.flushes, sess_t.events_folded) == \
        (sess_j.flushes, sess_j.events_folded) == (7, 40)
    assert sess_t.window.n_max == sess_j.window.n_max > 9
    prev = first_t
    for rt, rj in zip(reps_t, reps_j):
        assert isinstance(rt, te.WindowSolveReport)
        assert rt.method == "streaming"
        assert_report_matches_jax(rt, rj, rel)
        assert_passes_frozen_lanes_through(prev, rt)
        prev = rt
    np.testing.assert_array_equal(sess_t.window._mask, sess_j.window._mask)
    assert not sess_t.window.dirty.any()


def test_frozen_lanes_equal_a_cold_solve():
    """After a stream, each flush's resolved lanes equal a cold solve of the
    same window bit for bit (lanes are independent rows), and the frozen
    ones too: they are the equilibrium of an unchanged scenario."""
    _, et = engines("fused", flush={"max_events": 4})
    _, wt = window_pair(22, NS, n_max=9)
    sess = et.open_window(wt)
    sess.solve()
    trace = ts.sample_event_trace(23, wt, 16)
    for rep in sess.stream(trace):
        cold = tg.solve_distributed_batch(wt.batch, iter_fn=t_iter())
        for f in ("r", "aux"):
            assert_bitwise_equal(np_(getattr(rep.fractional, f)),
                                 np_(getattr(cold, f)), f)
        np.testing.assert_array_equal(np_(rep.iters), np_(cold.iters))
        np.testing.assert_array_equal(np_(rep.feasible), np_(cold.feasible))


def test_compaction_policy_matches_jax():
    """Departures push occupancy below the threshold; the flush compacts
    before it solves, with the JAX package's slot map, and the clean lanes
    stay frozen through the re-layout."""
    ej, et = engines(flush={"max_events": None},
                     compaction={"occupancy": 0.5, "headroom": 1.5})
    wj, wt = window_pair(24, (6, 7, 5, 6), n_max=12)
    sess_j, sess_t = ej.open_window(wj), et.open_window(wt)
    pre = sess_t.solve()
    assert_report_matches_jax(pre, sess_j.solve())
    departures = [jt.ClassDeparture(lane=b, slot=s) for b in (0, 1, 2)
                  for s in wj.occupied(b)[2:]]
    for ev, evt in zip(departures, port_events(departures)):
        assert sess_j.apply(ev) is None and sess_t.apply(evt) is None
    rep_j, rep_t = sess_j.flush(), sess_t.flush()
    assert rep_t.slot_map is not None and wt.n_max == wj.n_max == 9
    assert_report_matches_jax(rep_t, rep_j)
    assert not rep_t.resolved[3]
    kept = np.flatnonzero(rep_t.slot_map[3] >= 0)
    assert_bitwise_equal(np_(rep_t.fractional.r[3, rep_t.slot_map[3, kept]]),
                         np_(pre.fractional.r[3, kept]))
    assert sess_t.flush().slot_map is None          # clean: no-op echo


def test_offer_slack_drain_discard_and_noop_flush_match_jax():
    ej, et = engines(flush={"max_events": 3})
    wj, wt = window_pair(25, (3, 4), n_max=6)
    sess_j, sess_t = ej.open_window(wj), et.open_window(wt)
    assert sess_t.drain() == [] and sess_t.window.state is None
    first_t, first_j = sess_t.flush(), sess_j.flush()
    assert_report_matches_jax(first_t, first_j)
    again = sess_t.flush()                          # clean and solved
    assert again.fractional is first_t.fractional and again.slot_map is None
    assert sess_t.flushes == 1
    params = {k: float(v[0])
              for k, v in table5_raw(np.random.default_rng(5), 1).items()}
    events = [jt.ClassArrival(lane=0, params={**params, "E": -40.0}),
              jt.SLAEdit(lane=1, slot=0, updates={"E": -12.5}),
              jt.ClassDeparture(lane=1, slot=1)]
    for ev, evt in zip(events, port_events(events)):
        assert sess_t.offer(evt) == sess_j.offer(ev)
    assert sess_t.pending_slack() == sess_j.pending_slack() == 12.5
    assert sess_t.dirty_lanes == {int(b) for b in sess_j.dirty_lanes}
    dropped = sess_t.discard_pending()
    sess_j.discard_pending()
    assert len(dropped) == 3 and not sess_t.pending
    assert sess_t.pending_slack() == np.inf
    for ev, evt in zip(events[:2], port_events(events[:2])):
        sess_j.offer(ev)
        sess_t.offer(evt)
    assert sess_t.drain() == sess_j.drain() == [3, None]
    assert sess_t.last_slots == [3, None]
    assert sess_t.events_folded == sess_j.events_folded == 2
    assert_report_matches_jax(sess_t.flush(), sess_j.flush())
    assert sess_t.flushes == sess_j.flushes == 2


def test_quota_raises_on_offer_and_add_lane():
    _, et = engines(flush={"max_events": None})
    _, st = scenario_pairs(26, (3, 4))
    with pytest.raises(te.QuotaExceededError):
        et.open_window(st, quota=te.TenantQuota(max_lanes=1))
    sess = et.open_window(st, quota=te.TenantQuota(max_queued=2, max_lanes=3))
    assert te.TenantQuota().admits_event(10**9)
    for slot in (0, 1):
        sess.offer(tt.ClassDeparture(lane=0, slot=slot))
    with pytest.raises(te.QuotaExceededError, match="quota allows 2"):
        sess.offer(tt.ClassDeparture(lane=0, slot=2))
    assert sess.add_lane(R=100.0, rho_bar=1.5) == 2
    assert not sess.pending                          # drained first
    with pytest.raises(te.QuotaExceededError, match="quota allows 3"):
        sess.add_lane(R=100.0, rho_bar=1.5)


def test_geometry_verbs_match_jax():
    ej, et = engines(flush={"max_events": None})
    wj, wt = window_pair(27, (4, 5), n_max=6)
    sess_j, sess_t = ej.open_window(wj), et.open_window(wt)
    assert_report_matches_jax(sess_t.solve(), sess_j.solve())
    sj, st = scenario_pairs(28, (7,))
    ev = jt.ClassDeparture(lane=1, slot=2)
    sess_j.apply(ev)
    sess_t.apply(*port_events([ev]))
    assert sess_t.add_lane(st[0]) == sess_j.add_lane(sj[0]) == 2
    assert not sess_t.pending and sess_t.last_slots == [None]
    assert sess_t.add_lane(R=300.0, rho_bar=2.0) == \
        sess_j.add_lane(R=300.0, rho_bar=2.0)
    rt, rj = sess_t.flush(), sess_j.flush()
    assert_report_matches_jax(rt, rj)
    np.testing.assert_array_equal(rt.resolved, [False, True, True, True])
    sess_t.remove_lane(0)
    sess_j.remove_lane(0)
    np.testing.assert_array_equal(sess_t.compact(), sess_j.compact())
    assert_report_matches_jax(sess_t.flush(), sess_j.flush())


def test_deadline_policy_flushes_like_jax():
    ej, et = engines(flush={"max_events": 50, "deadline_slack_s": 30.0,
                            "flush_on_sla_tightening": True})
    wj, wt = window_pair(29, (3, 4), n_max=8)
    sess_j, sess_t = ej.open_window(wj), et.open_window(wt)
    sess_j.solve()
    sess_t.solve()
    trace = js.sample_event_trace(30, wj, 24)
    edits = [jt.SLAEdit(lane=0, slot=0, updates={"E": -10.0})]
    flushed_j = [sess_j.apply(ev) is not None for ev in trace + edits]
    flushed_t = [sess_t.apply(ev) is not None
                 for ev in port_events(trace + edits)]
    assert flushed_t == flushed_j and flushed_t[-1]
    assert sess_t.flushes == sess_j.flushes


def test_window_state_from_numpy_continues_like_jax():
    """A JAX window's state carried across with ``window_state_from_numpy``
    onto a port window of the same scenarios: the next flush agrees with
    JAX's, and its frozen lanes are JAX's stored equilibrium bit for bit."""
    ej, et = engines(flush={"max_events": None})
    wj, wt = window_pair(31, NS, n_max=9)
    sess_j = ej.open_window(wj)
    sess_j.solve()
    trace = js.sample_event_trace(32, wj, 10)
    for ev in trace:
        sess_j.apply(ev)
    sess_j.flush()
    wt.apply_epoch(port_events(trace))
    wt._state = convert.window_state_from_numpy(leaves(wj.state),
                                                device="cpu")
    wt.dirty[:] = wj.dirty
    more = js.sample_event_trace(33, wj, 3, p_arrive=0.0, p_depart=0.0,
                                 p_edit=1.0, p_capacity=0.0)
    sess_t = et.open_window(wt)
    for ev, evt in zip(more, port_events(more)):
        sess_j.apply(ev)
        sess_t.apply(evt)
    rj, rt = sess_j.flush(), sess_t.flush()
    assert_report_matches_jax(rt, rj)
    assert (~rt.resolved).any()
    for b in np.flatnonzero(~rt.resolved):
        assert_bitwise_equal(np_(rt.fractional.r[b]),
                             np.asarray(rj.fractional.r[b]))


def test_report_mask_does_not_alias_the_window():
    """A report's mask is a snapshot: later events rewrite the window's host
    mask in place, never the report's (on the CPU a tensor made with
    ``torch.from_numpy`` would share it)."""
    _, et = engines(flush={"max_events": None})
    _, wt = window_pair(34, (3, 4), n_max=5)
    sess = et.open_window(wt)
    rep = sess.flush()
    before = np_(rep.mask).copy()
    batch = wt.batch
    wt.apply(tt.ClassDeparture(lane=0, slot=0))
    wt.apply(tt.ClassDeparture(lane=1, slot=3))
    np.testing.assert_array_equal(np_(rep.mask), before)
    np.testing.assert_array_equal(np_(batch.mask), before)
    assert not np.shares_memory(np_(wt.batch.mask), wt._mask)
    assert sess.flush() is not rep                   # mask changed: solves


def test_cross_check_batches_stale_lanes_with_per_lane_totals():
    """The cross-check solves the stale lanes in one batched call; its
    memoized totals equal per-lane solves of each lane bit for bit (on the
    CPU), and the undercut guard raises."""
    _, et = engines(flush={"max_events": None}, cross_check=True)
    _, wt = window_pair(35, NS, n_max=9)
    rep = et.open_window(wt).flush()
    batch = wt.batch
    for b in range(wt.batch_size):
        lane = tree_map(lambda leaf: leaf[b], batch.scenarios)
        want = float(tc.solve_centralized(lane, mask=batch.mask[b]).total)
        assert wt.baseline_totals[b] == want
    assert not wt.baseline_stale.any()
    assert (np_(rep.centralized_gap) >= -1e-9).all()
    wt.baseline_totals[:] = wt.baseline_totals + 1e6   # fake a better optimum
    wt.dirty[0] = True
    with pytest.raises(RuntimeError, match="beats the exact"):
        et._solve_window(wt)


def test_engine_accepts_window_and_refuses_residency():
    """An engine solves a window and adopts it; a round-trip engine leaves
    it unresident, a resident engine (the port has one now) makes it
    resident on its first flush."""
    _, et = engines()
    _, wt = window_pair(36, (2, 3))
    rep = et.solve(wt)
    np.testing.assert_array_equal(np_(rep.mask), wt._mask)
    assert et.open_window(wt).window is wt
    et.open_window(wt).solve()
    assert not wt.is_resident and wt.resident_mesh is None
    mesh = lane_mesh(devices=["cpu"])
    res = te.CapacityEngine(te.SolverConfig(mesh=mesh, residency="resident"),
                            device="cpu")
    res.open_window(wt).flush()
    assert wt.is_resident and wt.resident_mesh == mesh
