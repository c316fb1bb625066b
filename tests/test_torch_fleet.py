"""Parity of the port's fleet simulator (``repro_torch.cluster``) with the JAX
package's, on the same numpy-seeded fleets.

Fleets are drawn with ``np.random.default_rng(seed)`` in the ranges of
``examples/multi_tenant_cluster.py`` (compute 0.2-1.8 s, collective
0.1-0.9 s, overhead 1.0 s a job at 256 chips; deadlines 15-120 s; H_up
8-20, H_low 2-8; penalties 15,000-30,000 cents; bids up to 20) with
``total_chips = round(0.95 * sum r_up)``, the paper's Sec. 5.2.1 capacity
factor.  Each package builds its own ``FleetSimulator``s from the same
numbers and profiles (``profiles=``: the dry-run roofline files are not in
the repository) and solves in f64.  Chips, admitted jobs, meshes,
iterations and feasibility are held exactly; totals within 64 ULPs of
their scale (``tests/_tolerance.py``); the derived constants within 16
ULPs, where torch's f64 ``sqrt`` on the CPU departs from numpy's (ROADMAP
Queue 3 item 4).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from _tolerance import assert_ulp_close
from repro import cluster as jc
from repro.core import InfeasibleError as JInfeasible
from repro_torch import cluster as tc
from repro_torch.core import InfeasibleError, lane_mesh
from repro_torch.core import engine as tengine
from repro_torch.kernels.gnep_sweep.ops import make_batched_sweep_fn

SQRT_FIELDS = ("xiM", "xiR", "K", "r_up", "r_low", "p")
TP_CHOICES = (1, 2, 4, 8, 16)


def draw_tenant(rng, name):
    """(TenantSpec fields, profile) of one tenant."""
    spec = dict(name=name, arch_id="qwen3-8b", shape="train_4k",
                deadline_s=float(rng.uniform(15.0, 120.0)),
                H_up=int(rng.integers(8, 21)), H_low=int(rng.integers(2, 9)),
                penalty_per_job=float(rng.uniform(15000.0, 30000.0)),
                max_bid=20.0, tp_required=int(rng.choice(TP_CHOICES)))
    prof = (float(rng.uniform(0.2, 1.8)), float(rng.uniform(0.1, 0.9)), 1.0)
    return spec, prof


def r_up(spec, prof):
    """The tenant's r_up in numpy (``derive``'s formula, c^M = c^R = 1)."""
    A, B = prof[0] * 256.0, max(prof[1], 1e-6) * 256.0
    K = (np.sqrt(A) + np.sqrt(B)) ** 2 / (spec["deadline_s"] - prof[2])
    return K * spec["H_up"]


def draw_fleet(rng, n, prefix, cf=0.95):
    """(total_chips, tenant fields, profiles) of one fleet of n tenants."""
    specs, profiles = [], {}
    for i in range(n):
        spec, prof = draw_tenant(rng, f"{prefix}t{i}")
        specs.append(spec)
        profiles[spec["name"]] = prof
    R = int(round(cf * sum(r_up(s, profiles[s["name"]]) for s in specs)))
    return R, specs, profiles


def build(pkg, drawn, **kw):
    """One package's FleetSimulator from drawn numbers."""
    R, specs, profiles = drawn
    f = pkg.FleetSimulator(R, [pkg.TenantSpec(**s) for s in specs], **kw)
    f._profiles = dict(profiles)
    return f


def pair(drawn):
    return build(jc, drawn), build(tc, drawn, device="cpu")


def draw_fleets(seed, sizes, cf=0.95):
    rng = np.random.default_rng(seed)
    return [draw_fleet(rng, n, f"f{b}", cf) for b, n in enumerate(sizes)]


def assert_same_alloc(got, want, label=""):
    assert got.chips == want.chips, label
    assert got.h == want.h, label
    assert got.meshes == want.meshes, label
    assert got.iters == want.iters, label
    assert got.feasible == want.feasible, label
    assert got.method == want.method, label
    assert_ulp_close(np.float64(got.total_cost), np.float64(want.total_cost),
                     ulps=64, err_msg=f"{label} total")


def test_scenario_matches_jax():
    for drawn in draw_fleets(0, (5, 40, 17)):
        jf, tf = pair(drawn)
        js, ts = jf.scenario(), tf.scenario()
        assert ts.A.device.type == "cpu" and ts.A.dtype == torch.float64
        for fld in dataclasses.fields(ts):
            got = getattr(ts, fld.name).numpy()
            want = np.asarray(getattr(js, fld.name))
            if fld.name in SQRT_FIELDS:
                assert_ulp_close(got, want, ulps=16, err_msg=fld.name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=fld.name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epoch_failure_restore_straggler_match_jax(seed):
    """epoch -> fail_nodes -> restore_nodes -> mark_straggler, each against
    JAX, and the reference's own contracts (``tests/test_substrate.py``):
    a failure leaves the chips within the smaller capacity at no lower
    cost, and restoring it returns exactly the first allocation."""
    drawn = draw_fleets(seed, (int(np.random.default_rng(seed)
                                   .integers(20, 60)),))[0]
    jf, tf = pair(drawn)
    k = int(0.2 * jf.R)
    steps = [("epoch", lambda f: f.epoch()),
             ("fail_nodes", lambda f: f.fail_nodes(k)),
             ("restore_nodes", lambda f: f.restore_nodes(k)),
             ("mark_straggler",
              lambda f: f.mark_straggler(f.tenants[3].name, 1.5))]
    got = []
    for label, step in steps:
        want = step(jf)
        got.append(step(tf))
        assert_same_alloc(got[-1], want, label)
    a0, a1, a2, _ = got
    assert sum(a0.chips.values()) <= tf.R
    assert sum(a1.chips.values()) <= tf.R - k
    assert a1.total_cost >= a0.total_cost - 1e-6
    assert a2 == a0
    assert tf.history == got
    assert all(len(m) == 2 and m[0] * m[1] <= max(c, 1)
               for a in got for m, c in zip(a.meshes.values(),
                                            a.chips.values()))


def test_straggler_overprovisions():
    """The reference's strict straggler check at its own two-tenant fleet
    (``tests/test_substrate.py::test_fleet_straggler_overprovisions``)."""
    tenants = [tc.TenantSpec("a", "x", "train_4k", deadline_s=100,
                             H_up=10, H_low=4, penalty_per_job=20000),
               tc.TenantSpec("b", "y", "decode_32k", deadline_s=50, H_up=8,
                             H_low=2, penalty_per_job=10000)]
    fleet = tc.FleetSimulator(total_chips=800, tenants=tenants,
                              device="cpu")
    a0 = fleet.epoch(profiles={"a": (1.0, 0.5, 1.0), "b": (0.5, 0.3, 1.0)})
    a1 = fleet.mark_straggler("a", factor=1.5)
    assert a1.chips["a"] > a0.chips["a"]


@pytest.mark.parametrize("sweep", [False, True])
def test_ragged_epoch_batch_matches_epochs_and_jax(sweep):
    """One batched epoch == each fleet's own epoch (the reference's
    contract, ``tests/test_batch.py``) and JAX's batched epoch; the sweep
    configuration (its plain version on the CPU) gives the same."""
    drawn = draw_fleets(3, (7, 31, 3, 18))
    singles = [build(tc, d, device="cpu") for d in drawn]
    expected = [f.epoch() for f in singles]
    jfleets = [build(jc, d) for d in drawn]
    tfleets = [build(tc, d, device="cpu") for d in drawn]
    jallocs = jc.epoch_batch(jfleets)
    tallocs = tc.epoch_batch(
        tfleets, sweep_fn=make_batched_sweep_fn() if sweep else None)
    assert len(tallocs) == 4
    for b, (got, want, single) in enumerate(zip(tallocs, jallocs, expected)):
        assert_same_alloc(got, want, f"fleet {b} against JAX")
        assert got.chips == single.chips and got.h == single.h
        assert got.meshes == single.meshes
        assert got.total_cost == pytest.approx(single.total_cost, rel=1e-9)
        assert tfleets[b].history == [got]


def test_epoch_batch_profiles_are_remembered():
    drawn = draw_fleets(4, (6, 9))
    fleets = [build(tc, d, device="cpu") for d in drawn]
    profs = [f._profiles for f in fleets]
    for f in fleets:
        del f._profiles
    first = tc.epoch_batch(fleets, profiles=profs)
    again = tc.epoch_batch(fleets)
    assert [a.chips for a in again] == [a.chips for a in first]


def test_epoch_batch_on_a_lane_mesh_equals_unsharded():
    """Five fleets over three CPU shards (one inert padding lane), bit for
    bit the unsharded epoch."""
    drawn = draw_fleets(5, (12, 4, 25, 9, 16))
    plain = tc.epoch_batch([build(tc, d, device="cpu") for d in drawn])
    sharded = tc.epoch_batch([build(tc, d, device="cpu") for d in drawn],
                             mesh=lane_mesh(devices=["cpu"] * 3))
    assert sharded == plain


def _stream_epochs(rng, drawn, n_epochs=6):
    """Abstract events of the reference's mix over ``n_epochs`` epochs:
    each epoch about a third of the fleets see an arrival (with its
    profile), a departure, an SLA edit or a capacity change; one fleet
    arrives in epoch 2 and one leaves in epoch 4.  Returns the epochs and
    the drawn newcomer fleet."""
    names = [[s["name"] for s in d[1]] for d in drawn]
    newcomer = draw_fleet(rng, 11, "new")
    epochs, fresh = [[]], 0
    for e in range(1, n_epochs):
        events = []
        for b in rng.choice(len(names), size=max(1, len(names) // 3),
                            replace=False):
            b = int(b)
            kind = ("arrive", "depart", "edit", "capacity")[
                int(rng.integers(4))]
            if kind == "arrive":
                spec, prof = draw_tenant(rng, f"arr{fresh}")
                fresh += 1
                names[b].append(spec["name"])
                events.append(("arrive", b, spec, prof))
            elif kind == "depart" and len(names[b]) > 2:
                name = names[b].pop(int(rng.integers(len(names[b]))))
                events.append(("depart", b, name))
            elif kind == "edit":
                name = names[b][int(rng.integers(len(names[b])))]
                events.append(("edit", b, name,
                               {"deadline_s": float(rng.uniform(20, 120)),
                                "penalty_per_job":
                                    float(rng.uniform(15000, 30000))}))
            else:
                events.append(("capacity", b, "scale",
                               float(rng.uniform(0.9, 1.2))))
        if e == 2:
            events.append(("fleet-arrive",))
            names.append([s["name"] for s in newcomer[1]])
        if e == 4:
            events.append(("fleet-depart", 0))
            del names[0]
        epochs.append(events)
    return epochs, newcomer


def _materialize(pkg, epochs, newcomer, fleets, **kw):
    """One package's event epochs.  Capacity changes scale the fleet's
    current R, resolved against that package's own fleets when the epoch
    is handed out (so the two stay equal event by event)."""
    for events in epochs:
        out = []
        order = list(fleets)
        for ev in events:
            if ev[0] == "arrive":
                out.append(("arrive", ev[1], pkg.TenantSpec(**ev[2]), ev[3]))
            elif ev[0] == "capacity":
                out.append(("capacity", ev[1],
                            int(round(order[ev[1]].R * ev[3]))))
            elif ev[0] == "fleet-arrive":
                f = build(pkg, newcomer, **kw)
                order.append(f)
                out.append(("fleet-arrive", f))
            elif ev[0] == "fleet-depart":
                del order[ev[1]]
                out.append(ev)
            else:
                out.append(ev)
        fleets[:] = order
        yield out


def test_epoch_stream_matches_jax_epoch_by_epoch(monkeypatch):
    """Arrivals, departures, SLA edits, capacity changes, a fleet arriving
    and one leaving, with ``compact_below=0.6`` (at least one compaction
    taken): every epoch's allocations equal JAX's, each fleet's history
    grows by one an epoch, and the last epoch equals a fresh
    ``epoch_batch`` of the post-event fleets (the reference's contract,
    ``tests/test_streaming.py``)."""
    rng = np.random.default_rng(6)
    drawn = draw_fleets(6, (8, 14, 5, 20, 11, 3))
    epochs, newcomer = _stream_epochs(rng, drawn)
    assert {ev[0] for events in epochs for ev in events} == {
        "arrive", "depart", "edit", "capacity", "fleet-arrive",
        "fleet-depart"}
    jfleets = [build(jc, d) for d in drawn]
    tfleets = [build(tc, d, device="cpu") for d in drawn]
    compactions = []
    flush = tengine.WindowSession.flush

    def spy(self):
        rep = flush(self)
        compactions.append(rep.slot_map is not None)
        return rep

    monkeypatch.setattr(tengine.WindowSession, "flush", spy)
    jcur, tcur = list(jfleets), list(tfleets)
    jgot = jc.epoch_stream(jfleets, _materialize(jc, epochs, newcomer, jcur),
                           n_max=24, compact_below=0.6)
    tgot = tc.epoch_stream(tfleets, _materialize(tc, epochs, newcomer, tcur,
                                                 device="cpu"),
                           n_max=24, compact_below=0.6)
    n = 0
    for e, (ja, ta) in enumerate(zip(jgot, tgot)):
        assert len(ta) == len(ja) == len(tcur)
        for b, (got, want) in enumerate(zip(ta, ja)):
            assert_same_alloc(got, want, f"epoch {e} fleet {b}")
        n += 1
    assert n == len(epochs) and any(compactions), compactions
    assert len(tcur[-1].history) == len(epochs) - 2      # arrived in epoch 2
    assert all(len(f.history) == len(epochs) for f in tcur[:-1])
    fresh = [copy.deepcopy(f) for f in tcur]
    for got, want in zip(ta, tc.epoch_batch(fresh)):
        assert got.chips == want.chips and got.h == want.h
        assert got.total_cost == pytest.approx(want.total_cost, rel=1e-6)


def test_epoch_stream_refuses_a_duplicate_tenant():
    drawn = draw_fleets(7, (4, 6))
    fleets = [build(tc, d, device="cpu") for d in drawn]
    dup = tc.TenantSpec(**drawn[0][1][0])
    with pytest.raises(ValueError, match="already has a tenant"):
        list(tc.epoch_stream(fleets, [[("arrive", 0, dup)]]))
    twice = tc.TenantSpec(**{**drawn[0][1][0], "name": "twice"})
    with pytest.raises(ValueError, match="already has a tenant"):
        list(tc.epoch_stream(fleets, [[("arrive", 1, twice, (1., .5, 1.)),
                                       ("arrive", 1, twice)]]))
    with pytest.raises(ValueError, match="unknown fleet event"):
        list(tc.epoch_stream(fleets, [[("resize", 0, 3)]]))


def test_infeasible_fleets_raise_where_jax_raises():
    """A fleet whose guaranteed minimum exceeds its capacity: ``epoch`` and
    ``epoch_batch`` raise ``InfeasibleError`` as JAX does (naming the
    lane), ``epoch_stream`` flags it."""
    good, bad = draw_fleets(8, (6, 9))
    bad = (int(bad[0] * 0.2), bad[1], bad[2])
    jf, tf = pair(bad)
    with pytest.raises(JInfeasible):
        jf.epoch()
    with pytest.raises(InfeasibleError):
        tf.epoch()
    with pytest.raises(JInfeasible, match=r"\[1\]"):
        jc.epoch_batch([build(jc, good), build(jc, bad)])
    with pytest.raises(InfeasibleError, match=r"\[1\]"):
        tc.epoch_batch([build(tc, good, device="cpu"),
                        build(tc, bad, device="cpu")])
    (allocs,) = tc.epoch_stream([build(tc, good, device="cpu"),
                                 build(tc, bad, device="cpu")], [[]])
    assert [a.feasible for a in allocs] == [True, False]


def test_fleets_default_to_the_card(monkeypatch):
    """Without CUDA, a fleet refuses its default device; fleets on two
    devices are not solved together."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    drawn = draw_fleets(9, (3,))[0]
    with pytest.raises(RuntimeError, match="cuda"):
        build(tc, drawn)
    a, b = build(tc, drawn, device="cpu"), build(tc, drawn, device="cpu")
    b.device = torch.device("meta")
    with pytest.raises(ValueError, match="one device"):
        tc.epoch_batch([a, b])
    with pytest.raises(ValueError, match="one device"):
        list(tc.epoch_stream([a, b], [[]]))
    with pytest.raises(ValueError, match="at least one fleet"):
        tc.epoch_batch([])


@pytest.mark.parametrize("chips,tp,want", [
    (137, 16, (8, 16)), (8, 16, (1, 8)), (0, 16, (1, 1)), (16, 16, (1, 16)),
    (33, 1, (33, 1)), (5, 4, (1, 4)), (3, 4, (1, 3))])
def test_mesh_plan_matches_jax(chips, tp, want):
    assert tc.FleetSimulator.mesh_plan(chips, tp) == want
    assert jc.FleetSimulator.mesh_plan(chips, tp) == want


def test_package_exports_match_jax():
    assert tc.__all__ == jc.__all__
    assert ([f.name for f in dataclasses.fields(tc.TenantSpec)]
            == [f.name for f in dataclasses.fields(jc.TenantSpec)])
    assert ([f.name for f in dataclasses.fields(tc.Allocation)]
            == [f.name for f in dataclasses.fields(jc.Allocation)])
