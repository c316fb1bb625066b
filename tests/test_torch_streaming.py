"""Parity of the port's admission window (``repro_torch.core.streaming``)
with the JAX package: construction, every event kind, coalesced epochs,
growth, lane changes, compaction, warm starts, flush policies and traces.

Both windows are built from the same numpy-drawn instances
(``tests/_torch_parity.py``); events are drawn on the JAX side and handed to
the port as plain records.  Tolerances: masks, slots, ``n_max``,
``slot_map``, raw parameters and flags are exact, and so is every leaf that
involves no square root (raw fields, neutral fills, ``psi``, ``alpha``,
``beta``, ``rho_hat``, ``R``).  The constants derived through ``sqrt``
(``xiM``, ``xiR``, ``K``, ``r_up``, ``r_low``, ``p``) are held to 16 ULPs
relative: torch's f64 ``sqrt`` on the CPU is not correctly rounded
everywhere (about 1 value in 100 lands one ULP off numpy's), and the JAX
window derives in a jitted program whose ``m / K`` XLA rewrites.  Within
the port, coalesced and per-event application are bitwise equal, and every
derived constant is bitwise what ``stack_scenarios`` derives on the same
device.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal
from _torch_parity import (event_record, leaves, np_, port_events,
                           scenario_pairs, table5_raw, window_pair)
from repro.core import engine as je
from repro.core import streaming as js
from repro.core import types as jt
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.core import game as tg
from repro_torch.core import streaming as ts
from repro_torch.core import types as tt
from repro_torch.core.sharding import lane_mesh as ts_lane_mesh

FIELDS = [f.name for f in dataclasses.fields(tt.Scenario)]
SQRT_DERIVED = ("xiM", "xiR", "K", "r_up", "r_low", "p")


def class_params(seed):
    """One class's raw parameters as Python floats (numpy-drawn)."""
    raw = table5_raw(np.random.default_rng(seed), 1)
    return {k: float(v[0]) for k, v in raw.items()}


def assert_leaves_match_jax(wt, wj):
    """Every Scenario leaf of the port window against the JAX window's."""
    for f in FIELDS:
        got, want = np_(getattr(wt._scn, f)), np.asarray(getattr(wj._scn, f))
        if f in SQRT_DERIVED:
            eps = np.finfo(want.dtype).eps
            np.testing.assert_allclose(got, want, rtol=16 * eps, atol=0,
                                       err_msg=f)
        else:
            assert_bitwise_equal(got, want, f)


def assert_window_matches_jax(wt, wj):
    np.testing.assert_array_equal(wt._mask, wj._mask)
    assert wt._raw == wj._raw
    np.testing.assert_array_equal(wt.dirty, wj.dirty)
    np.testing.assert_array_equal(wt.baseline_stale, wj.baseline_stale)
    np.testing.assert_array_equal(wt._rho_bar_host, wj._rho_bar_host)
    assert_leaves_match_jax(wt, wj)


def assert_windows_bitwise(a, b):
    """Two port windows: host book-keeping equal, every leaf bitwise."""
    np.testing.assert_array_equal(a._mask, b._mask)
    assert a._raw == b._raw
    np.testing.assert_array_equal(a.dirty, b.dirty)
    for f in FIELDS:
        assert_bitwise_equal(np_(getattr(a._scn, f)), np_(getattr(b._scn, f)),
                             f)


def restacked(window):
    """The port's ``stack_scenarios`` over each lane's occupied slots,
    derived afresh from the window's raw book and lane scalars, scattered
    back to the window's slots: what the window's leaves must equal."""
    R, rho_bar = np_(window._scn.R), np_(window._scn.rho_bar)
    out = {f: np_(getattr(window._scn, f)).copy() for f in FIELDS}
    for b in range(window.batch_size):
        slots = window.occupied(b)
        if not slots:
            continue
        raw = {f: torch.tensor([window._raw[(b, s)][f] for s in slots],
                               dtype=window._scn.A.dtype)
               for f in tt.RAW_CLASS_FIELDS}
        scn = tt.derive(**raw, R=float(R[b]), rho_bar=float(rho_bar[b]),
                        device="cpu")
        one = tt.stack_scenarios([scn], device="cpu").scenarios
        for f in ts._CLASS_FIELDS:
            out[f][b, slots] = np_(getattr(one, f))[0]
        out["rho_hat"][b] = float(one.rho_hat[0])
    return out


# --------------------------------------------------------------------------
# construction and events
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_max", [None, 11])
def test_construction_matches_jax(n_max):
    """Ragged lanes, with and without headroom: mask, leaves, raw book."""
    wj, wt = window_pair(0, ns=(5, 8, 3, 6), n_max=n_max)
    assert (wt.batch_size, wt.n_max) == (wj.batch_size, wj.n_max)
    np.testing.assert_array_equal(wt.n_classes, wj.n_classes)
    assert wt.occupancy == wj.occupancy
    assert wt.state is None and not wt.is_resident and wt.resident_mesh is None
    assert_window_matches_jax(wt, wj)
    batch = wt.batch
    np.testing.assert_array_equal(np_(batch.mask), wj._mask)
    np.testing.assert_array_equal(np_(batch.n_classes), wj.n_classes)


def test_construction_validation():
    _, st = scenario_pairs(0, (3, 4))
    with pytest.raises(ValueError, match="at least one lane"):
        ts.AdmissionWindow([])
    with pytest.raises(ValueError, match="growth_factor"):
        ts.AdmissionWindow(st, growth_factor=1.0)
    meta = tt.Scenario(**{f: getattr(st[1], f).to("meta") for f in FIELDS})
    with pytest.raises(ValueError, match="more than one device"):
        ts.AdmissionWindow([st[0], meta])


@pytest.mark.parametrize("kind", ["arrival", "departure", "edit", "capacity",
                                  "depart-then-arrive"])
def test_apply_each_kind_matches_jax(kind):
    """One event of each kind (and a recycled slot) through ``apply``."""
    wj, wt = window_pair(1, ns=(4, 6), n_max=7)
    events = {
        "arrival": [jt.ClassArrival(lane=1, params=class_params(1))],
        "departure": [jt.ClassDeparture(lane=0, slot=2)],
        "edit": [jt.SLAEdit(lane=1, slot=3,
                            updates={"E": -700.0, "m": 21000.0,
                                     "rho_up": 17.5})],
        "capacity": [jt.CapacityChange(lane=0, R=1234.5)],
        "depart-then-arrive": [jt.ClassDeparture(lane=0, slot=1),
                               jt.ClassArrival(lane=0,
                                               params=class_params(2))],
    }[kind]
    slots_j = [wj.apply(ev) for ev in events]
    slots_t = [wt.apply(ev) for ev in port_events(events)]
    assert slots_t == slots_j
    if kind == "depart-then-arrive":
        assert slots_t[1] == 1                       # the vacated slot
    assert_window_matches_jax(wt, wj)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_epoch_equals_sequential_and_jax(seed):
    """A 40-event trace that grows the window and recycles slots: the
    port's coalesced epoch is bitwise its per-event replay, both equal the
    JAX window after the same trace, and every leaf is bitwise what
    ``stack_scenarios`` derives from the raw parameters."""
    wj, wt_seq = window_pair(seed, n_max=9)
    _, wt_co = window_pair(seed, n_max=9)
    trace = js.sample_event_trace(40 + seed, wj, 40)
    slots_j = [wj.apply(ev) for ev in trace]
    events = port_events(trace)
    slots_seq = [wt_seq.apply(ev) for ev in events]
    slots_co = wt_co.apply_epoch(events)
    assert slots_seq == slots_co == slots_j
    assert wt_co.n_max == wj.n_max > 9               # the trace grew it
    assert_windows_bitwise(wt_seq, wt_co)
    assert_window_matches_jax(wt_co, wj)
    want = restacked(wt_co)
    for f in ts._CLASS_FIELDS + ("rho_hat",):
        assert_bitwise_equal(np_(getattr(wt_co._scn, f)), want[f], f)
    assert wt_co.apply_epoch([]) == []


def test_apply_epoch_folds_in_epoch_chains_like_jax():
    """arrive -> edit -> depart of one slot, and a recycled slot, inside one
    epoch fold to the JAX package's net state."""
    wj, wt = window_pair(2, ns=(3, 4))
    events = [
        jt.ClassArrival(lane=0, params=class_params(3)),      # -> slot 3
        jt.SLAEdit(lane=0, slot=3, updates={"E": -450.0, "m": 31000.0}),
        jt.ClassDeparture(lane=0, slot=0),
        jt.ClassArrival(lane=0, params=class_params(4)),      # recycles 0
        jt.ClassDeparture(lane=0, slot=3),
        jt.ClassDeparture(lane=1, slot=2),
        jt.CapacityChange(lane=1, R=99.0),
    ]
    assert wt.apply_epoch(port_events(events)) == wj.apply_epoch(events)
    assert_window_matches_jax(wt, wj)
    assert wt.occupied(0) == [0, 1, 2]


def test_growth_schedule_matches_jax():
    """A burst into one lane grows the window twice on the same schedule."""
    wj, wt = window_pair(3, ns=(3, 2), n_max=3, growth_factor=1.5)
    burst = [jt.ClassArrival(lane=0, params=class_params(10 + i))
             for i in range(4)]
    widths_j, widths_t = [], []
    for ev, et in zip(burst, port_events(burst)):
        wj.apply(ev)
        wt.apply(et)
        widths_j.append(wj.n_max)
        widths_t.append(wt.n_max)
    assert widths_t == widths_j == [5, 5, 8, 8]
    assert [ts.grown_n_max(n, g) for n, g in ((3, 1.5), (5, 1.5), (7, 1.01),
                                              (512, 2.0))] == \
        [js.grown_n_max(n, g) for n, g in ((3, 1.5), (5, 1.5), (7, 1.01),
                                           (512, 2.0))]
    assert_window_matches_jax(wt, wj)
    with pytest.raises(ValueError, match="must exceed"):
        wt.grow(wt.n_max)


def test_apply_epoch_is_atomic():
    """An invalid event anywhere in an epoch raises before anything changes:
    mask, leaves, raw book, flags and the stored state.  The invalid
    departure and edit address lane 0, which the valid prefix (arrivals to
    lane 1 only) cannot fill, so the events stay invalid after any prefix."""
    _, wt = window_pair(4, ns=(3, 4), n_max=6)
    te.CapacityEngine(device="cpu").open_window(wt).solve()
    before = {f: np_(getattr(wt._scn, f)).copy() for f in FIELDS}
    mask, raw = wt._mask.copy(), dict(wt._raw)
    state = [np_(x).copy() for x in wt.state]
    good = [tt.ClassArrival(lane=1, params=class_params(20 + i))
            for i in range(6)]                      # grows the window, too
    bad_epochs = [
        (IndexError, good + [tt.ClassDeparture(lane=0, slot=4)]),
        (IndexError, good + [tt.SLAEdit(lane=0, slot=5, updates={"E": -1.})]),
        (IndexError, good + [tt.ClassDeparture(lane=2, slot=0)]),
        (ValueError, good + [tt.SLAEdit(lane=0, slot=0,
                                        updates={"nope": 1.0})]),
        (ValueError, good + [tt.ClassArrival(lane=0, params={"A": 1.0})]),
        (TypeError, good + ["not-an-event"]),
    ]
    for exc, epoch in bad_epochs:
        for cut in (0, 3, len(good)):
            with pytest.raises(exc):
                wt.apply_epoch(epoch[:cut] + epoch[-1:])
    np.testing.assert_array_equal(wt._mask, mask)
    assert wt._raw == raw and not wt.dirty.any() and wt.n_max == 6
    for f in FIELDS:
        assert_bitwise_equal(np_(getattr(wt._scn, f)), before[f], f)
    for got, want in zip(wt.state, state):
        assert_bitwise_equal(np_(got), want)


def test_single_event_verbs_validate_like_jax():
    wj, wt = window_pair(5, ns=(3, 4))
    for w, E in ((wj, jt), (wt, tt)):
        with pytest.raises(IndexError):
            w.depart(0, 3)
        with pytest.raises(IndexError):
            w.apply(E.ClassArrival(lane=5, params=class_params(0)))
        with pytest.raises(ValueError):
            w.edit(0, 0, nope=1.0)
        with pytest.raises(ValueError):
            w.arrive(1, A=1.0)
        with pytest.raises(TypeError):
            w.apply("not-an-event")
    assert wt.arrive(0, **class_params(6)) == wj.arrive(0, **class_params(6))
    wt.edit(1, 2, E=-300.0)
    wj.edit(1, 2, E=-300.0)
    wt.set_capacity(0, 500.0)
    wj.set_capacity(0, 500.0)
    wt.depart(1, 0)
    wj.depart(1, 0)
    assert_window_matches_jax(wt, wj)


# --------------------------------------------------------------------------
# window layout: lanes, compaction, warm starts
# --------------------------------------------------------------------------


def _solved_pair(seed, ns=(5, 8, 3, 6), n_max=9, n_events=12):
    """Window pair solved once on both sides, then churned by a trace."""
    wj, wt = window_pair(seed, ns=ns, n_max=n_max)
    je.CapacityEngine().open_window(wj).solve()
    te.CapacityEngine(device="cpu").open_window(wt).solve()
    trace = js.sample_event_trace(60 + seed, wj, n_events, p_arrive=0.2,
                                  p_depart=0.6, p_edit=0.1, p_capacity=0.1)
    wj.apply_epoch(trace)
    wt.apply_epoch(port_events(trace))
    return wj, wt


def assert_state_matches_jax(wt, wj, rel=1e-12):
    st_t, st_j = wt.state, wj.state
    np.testing.assert_allclose(np_(st_t.r), np.asarray(st_j.r), rtol=rel,
                               atol=0)
    np.testing.assert_allclose(np_(st_t.rho), np.asarray(st_j.rho), rtol=rel,
                               atol=0)
    np.testing.assert_array_equal(np_(st_t.lane_iters),
                                  np.asarray(st_j.lane_iters))
    np.testing.assert_array_equal(np_(st_t.solved), np.asarray(st_j.solved))


def test_compact_matches_jax_and_solves_like_the_uncompacted_window():
    wj, wt = _solved_pair(6)
    _, wt_wide = _solved_pair(6)
    assert not wt._mask[:, -1].all()                 # holes to pack
    map_j, map_t = wj.compact(), wt.compact()
    np.testing.assert_array_equal(map_t, map_j)
    assert wt.n_max == wj.n_max == max(int(wt.n_classes.max()), 1)
    assert_window_matches_jax(wt, wj)
    assert_state_matches_jax(wt, wj)
    eng = te.CapacityEngine(device="cpu")
    packed = eng.open_window(wt).solve()
    wide = eng.open_window(wt_wide).solve()
    np.testing.assert_array_equal(packed.resolved, wide.resolved)
    np.testing.assert_array_equal(np_(packed.iters), np_(wide.iters))
    for b in range(wt.batch_size):
        old = np.flatnonzero(map_t[b] >= 0)
        np.testing.assert_allclose(np_(packed.fractional.r[b, map_t[b, old]]),
                                   np_(wide.fractional.r[b, old]),
                                   rtol=1e-12, atol=0)
    np.testing.assert_allclose(np_(packed.fractional.aux),
                               np_(wide.fractional.aux), rtol=1e-12, atol=0)
    # already packed: identity map, nothing moves
    again = wt.compact()
    for b in range(wt.batch_size):
        occ = wt.occupied(b)
        np.testing.assert_array_equal(again[b, occ], occ)
    with pytest.raises(ValueError, match="below the widest"):
        wt.compact(n_max=wt.n_max - 1)


def test_add_and_remove_lane_match_jax():
    wj, wt = _solved_pair(7)
    sj, st = scenario_pairs(70, (12,))
    assert wt.add_lane(st[0]) == wj.add_lane(sj[0]) == 4   # grows to 12
    assert wt.n_max == wj.n_max == 12
    assert wt.add_lane(R=300.0, rho_bar=2.0) == \
        wj.add_lane(R=300.0, rho_bar=2.0)
    assert_window_matches_jax(wt, wj)
    assert_state_matches_jax(wt, wj)
    for w in (wj, wt):
        w.remove_lane(1)
    assert_window_matches_jax(wt, wj)
    assert_state_matches_jax(wt, wj)
    np.testing.assert_array_equal(wt.baseline_totals, wj.baseline_totals)
    with pytest.raises(ValueError, match="explicit R"):
        wt.add_lane()
    single = ts.AdmissionWindow(st)
    with pytest.raises(ValueError, match="last lane"):
        single.remove_lane(0)


def test_warm_start_and_commit_match_jax():
    wj, wt = _solved_pair(8, n_events=2)
    ij, it = wj.warm_start(), wt.warm_start()
    np.testing.assert_array_equal(np_(it.active), np.asarray(ij.active))
    assert 0 < int(np_(it.active).sum()) < wt.batch_size
    np.testing.assert_array_equal(np_(it.lane_iters), np.asarray(ij.lane_iters))
    for f in ("r", "bids", "rho"):
        np.testing.assert_allclose(np_(getattr(it, f)),
                                   np.asarray(getattr(ij, f)), rtol=1e-12,
                                   atol=0, err_msg=f)
    r = np.asarray(ij.r)
    wj.commit(r, np.asarray(ij.rho), np.asarray(ij.lane_iters))
    wt.commit(torch.tensor(r), torch.tensor(np.asarray(ij.rho)),
              torch.tensor(np.asarray(ij.lane_iters)))
    assert_state_matches_jax(wt, wj, rel=0)
    assert not wt.dirty.any()
    assert wt.state.lane_iters.dtype == torch.int32
    cold_t = wt.warm_start()
    assert not np_(cold_t.active).any()              # every lane frozen


# --------------------------------------------------------------------------
# policies, epochs, traces
# --------------------------------------------------------------------------


def test_flush_policy_matches_jax():
    wj, wt = window_pair(9, ns=(3, 4, 2, 5), n_max=8)
    trace = js.sample_event_trace(90, wj, 30)
    edits = [jt.SLAEdit(lane=1, slot=0, updates={"E": E})
             for E in (-1e4, -5.0, 2.0)]
    edits.append(jt.SLAEdit(lane=1, slot=0, updates={"m": 1.0}))
    events = trace + edits + [jt.ClassArrival(lane=0, params={
        **class_params(91), "E": -3.0})]
    policies = [
        ({}, {}),
        ({"max_events": 3, "max_dirty_fraction": 0.5},) * 2,
        ({"max_events": None},) * 2,
    ]
    pairs = [(js.FlushPolicy(**a), ts.FlushPolicy(**b)) for a, b in policies]
    pairs += [(js.FlushPolicy.deadline(s, tightening=t),
               ts.FlushPolicy.deadline(s, tightening=t))
              for s in (0.0, 10.0, -5.0) for t in (True, False)]
    for pj, pt in pairs:
        assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
        for ev, et in zip(events, port_events(events)):
            assert pt.is_critical(et, wt) == pj.is_critical(ev, wj)
        for n_events, n_dirty in ((0, 0), (3, 1), (8, 2), (9, 4)):
            assert (pt.should_flush(n_events=n_events, n_dirty=n_dirty,
                                    batch_size=4)
                    == pj.should_flush(n_events=n_events, n_dirty=n_dirty,
                                       batch_size=4))


def test_event_epoch_matches_jax():
    """EventEpoch: the same flush decisions, slot grants and per-flush
    re-solves as the JAX epoch on the same trace."""
    wj, wt = window_pair(10, n_max=9)
    trace = js.sample_event_trace(100, wj, 20)
    pol = {"max_events": 5, "max_dirty_fraction": 0.75}
    ej, et = js.EventEpoch(wj, js.FlushPolicy(**pol)), \
        ts.EventEpoch(wt, ts.FlushPolicy(**pol))
    def flush_both():
        rj, rt = ej.flush(cross_check=True), et.flush(cross_check=True)
        assert et.last_slots == ej.last_slots
        np.testing.assert_array_equal(rt.resolved, rj.resolved)
        np.testing.assert_array_equal(np_(rt.iters), np.asarray(rj.iters))
        np.testing.assert_array_equal(np_(rt.integer.r),
                                      np.asarray(rj.integer.r))
        np.testing.assert_allclose(np_(rt.fractional.r),
                                   np.asarray(rj.fractional.r),
                                   rtol=1e-12, atol=1e-12)

    for ev, evt in zip(trace, port_events(trace)):
        due_j, due_t = ej.add(ev), et.add(evt)
        assert due_t == due_j and len(et) == len(ej)
        assert et.dirty_lanes == {int(b) for b in ej.dirty_lanes}
        if due_j:
            flush_both()
    assert et.pending and len(et.pending) == len(ej.pending)
    flush_both()
    assert (et.flushes, et.events_folded) == (ej.flushes, ej.events_folded)
    assert et.flushes >= 2 and not et.pending


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_event_trace_matches_jax_structure(seed):
    """Same seed, same window: the same kinds, lanes, slots and capacities;
    only the class parameter values differ.  The port's trace replays onto
    the port window and is deterministic."""
    wj, wt = window_pair(seed, ns=(2, 3, 1), n_max=3)
    tj = js.sample_event_trace(seed, wj, 60)
    tp = ts.sample_event_trace(seed, wt, 60)
    assert len(tp) == len(tj)
    for a, b in zip(tp, tj):
        assert type(a).__name__ == type(b).__name__
        assert a.lane == b.lane
        assert getattr(a, "slot", None) == getattr(b, "slot", None)
        assert getattr(a, "R", None) == getattr(b, "R", None)
        if isinstance(a, tt.ClassArrival):
            assert set(a.params) == set(tt.RAW_CLASS_FIELDS)
        if isinstance(a, tt.SLAEdit):
            assert set(a.updates) == set(b.updates)
    kinds = {type(a).__name__ for a in tp}
    assert kinds == {"ClassArrival", "ClassDeparture", "SLAEdit",
                     "CapacityChange"}
    assert [event_record(e) for e in tp] == \
        [event_record(e) for e in ts.sample_event_trace(seed, wt, 60)]
    ts.replay(wt, tp)
    js.replay(wj, tj)
    np.testing.assert_array_equal(wt._mask, wj._mask)
    assert wt.n_max == wj.n_max > 3
    drawn = ts.sample_event_trace(seed, wt, 5, p_arrive=1.0, p_depart=0.0,
                                  p_edit=0.0, p_capacity=0.0,
                                  params_fn=lambda gen: class_params(1))
    assert all(e.params == class_params(1) for e in drawn)


def test_event_records_round_trip_and_validate():
    events = [jt.ClassArrival(lane=1, params=class_params(0)),
              jt.ClassDeparture(lane=0, slot=np.int64(2)),
              jt.SLAEdit(lane=2, slot=1, updates={"E": np.float64(-3.0)}),
              jt.CapacityChange(lane=0, R=np.float32(12.5))]
    got = port_events(events)
    assert [type(e) for e in got] == [tt.ClassArrival, tt.ClassDeparture,
                                      tt.SLAEdit, tt.CapacityChange]
    assert [event_record(e) for e in got] == [event_record(e) for e in events]
    assert type(got[1].slot) is int and type(got[3].R) is float
    with pytest.raises(ValueError, match="unknown event kind"):
        convert.event_from_record({"kind": "Nope", "lane": 0})


def test_window_state_from_numpy_bitwise():
    wj, _ = _solved_pair(11)
    st = convert.window_state_from_numpy(leaves(wj.state), device="cpu")
    for got, want in zip(st, wj.state):
        assert_bitwise_equal(np_(got), np.asarray(want))
    assert st.lane_iters.dtype == torch.int32 and st.solved.dtype == torch.bool
    st32 = convert.window_state_from_numpy(leaves(wj.state), device="cpu",
                                           dtype=torch.float32)
    assert st32.r.dtype == torch.float32 and st32.solved.dtype == torch.bool


def test_residency_is_refused_with_item_10():
    """The resident layout is ported (the name predates it): before
    ``make_resident`` the resident views refuse, after it they carry the
    padded lanes (3 on a 2-shard mesh -> 4), and ``release_resident``
    restores the window bit for bit."""
    _, wt = window_pair(12, ns=(2, 3, 4))
    for call in (lambda: wt.resident_batch(),
                 lambda: wt.resident_warm_start(wt.batch)):
        with pytest.raises(RuntimeError, match="not device-resident"):
            call()
    wt.release_resident()                             # a no-op when not
    before = {f: np_(getattr(wt._scn, f)).copy() for f in FIELDS}
    wt.make_resident(ts_lane_mesh(devices=["cpu"] * 2))
    assert wt.is_resident and wt.resident_mesh.devices.size == 2
    rb = wt.resident_batch()
    assert rb.batch_size == 4 and not np_(rb.mask[3]).any()
    init, resolved = wt.resident_warm_start(rb)
    assert init.active.shape == (4,) and resolved.all()
    assert wt.batch.batch_size == 3
    wt.release_resident()
    assert not wt.is_resident and wt.resident_mesh is None
    for f in FIELDS:
        assert_bitwise_equal(np_(getattr(wt._scn, f)), before[f], f)


def test_cold_start_of_window_batch_matches_game():
    """The first warm start is the plain cold start of the window's batch."""
    _, wt = window_pair(13, ns=(2, 5, 3), n_max=6)
    got, want = wt.warm_start(), tg.cold_start(wt.batch)
    for a, b in zip(got, want):
        assert_bitwise_equal(np_(a), np_(b))
