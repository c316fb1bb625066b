"""The port's admission daemon, server and client, and their interplay with
the JAX package's over the wire.

Within the port (``repro_torch.serving``), every contract of
``tests/test_allocd.py`` and ``tests/test_wire.py`` is held on the CPU: per
tenant, the daemon's flush reports are bit for bit an offline
``WindowSession.stream`` replay of its delivered events (random traces,
open-loop schedules, resident tenants, over a socket), with backpressure,
quotas, drain, abort, slack order and fair intake as in the reference.

Across stacks, over loopback in one process: a JAX ``AllocClient`` drives
a torch ``AllocServer`` and a torch client a JAX server.  Each result equals
the serving stack's offline replay of what it received (the decoded lanes
and events) bit for bit, and the other stack's replay within the window
tests' tolerance: iterations, feasibility and masks exactly, every other
field within 1e-12 of its scale (its largest magnitude, at least 1; for
the penalty, the total's).
"""
import asyncio
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal
from _torch_parity import np_, scenario_pairs
from repro.core import engine as je
from repro.core import streaming as js
from repro.core import types as jt
from repro.serving import allocd as jd
from repro.serving import client as jc
from repro.serving import server as jsrv
from repro.serving import wire as jw
from repro_torch.core import engine as te
from repro_torch.core import streaming as ts
from repro_torch.core import types as tt
from repro_torch.core.planning import class_generator
from repro_torch.core.profiles import sample_class_params
from repro_torch.core.sharding import lane_mesh
from repro_torch.launch import allocd as allocd_cli
from repro_torch.serving import wire as tw
from repro_torch.serving.allocd import (AllocDaemon, drive_open_loop,
                                        flash_crowd_times, interleave_traces,
                                        poisson_times, rejection_penalty)
from repro_torch.serving.client import AllocClient
from repro_torch.serving.server import AllocServer

NS, N_MAX = (4, 3, 5), 8
SOLUTION_FIELDS = ("r", "psi", "sM", "sR", "cost", "penalty", "total",
                   "feasible", "iters", "aux")


def make_engine(flush_k=3, slack=None, mesh=None):
    flush = (ts.FlushPolicy.deadline(slack, max_events=flush_k)
             if slack is not None else ts.FlushPolicy(max_events=flush_k))
    cfg = (te.SolverConfig() if mesh is None
           else te.SolverConfig(mesh=mesh, residency="resident"))
    return te.CapacityEngine(cfg, te.Policies(
        flush=flush, rounding=te.RoundingPolicy(enabled=False)),
        device="cpu")


def jax_engine(flush_k=3):
    return je.CapacityEngine(je.SolverConfig(), je.Policies(
        flush=js.FlushPolicy(max_events=flush_k),
        rounding=je.RoundingPolicy(enabled=False)))


def lanes(seed):
    """(JAX lanes, port lanes on the CPU) of one drawn tenant."""
    return scenario_pairs(seed, NS, capacity_factor=1.3)


def make_window(seed):
    return ts.AdmissionWindow(lanes(seed)[1], n_max=N_MAX)


def arrival(seed, E=None):
    params = sample_class_params(torch.Generator().manual_seed(seed))
    if E is not None:
        params["E"] = E
    return tt.ClassArrival(lane=seed % len(NS), params=params)


def trace(seed, window_seed, n):
    return ts.sample_event_trace(seed, make_window(window_seed), n)


def offline_replay(seed, events, flush_k=3):
    return list(make_engine(flush_k).open_window(make_window(seed))
                .stream(events))


def assert_reports_bitequal(got, want, *, prefix=False):
    assert len(got) <= len(want) if prefix else len(got) == len(want)
    for a, b in zip(got, want):
        for f in SOLUTION_FIELDS:
            assert_bitwise_equal(np_(getattr(a.fractional, f)),
                                 np_(getattr(b.fractional, f)), f)
        assert_bitwise_equal(np_(a.iters), np_(b.iters), "iters")
        assert_bitwise_equal(np_(a.mask), np_(b.mask), "mask")


def assert_reports_close(got, want, rel=1e-12):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("iters", "feasible"):
            np.testing.assert_array_equal(np_(getattr(a.fractional, f)),
                                          np_(getattr(b.fractional, f)))
        np.testing.assert_array_equal(np_(a.mask), np_(b.mask))
        total = max(float(np.abs(np_(b.fractional.total)).max()), 1.0)
        for f in ("r", "psi", "sM", "sR", "cost", "penalty", "total", "aux"):
            x, y = np_(getattr(a.fractional, f)), np_(getattr(b.fractional, f))
            scale = total if f == "penalty" else max(
                float(np.abs(y).max()), 1.0)
            np.testing.assert_allclose(x, y, rtol=0, atol=rel * scale,
                                       err_msg=f)


async def submit_interleaved(daemon, traces, *, yield_between=True):
    tickets = {name: [] for name in traces}
    for evs in itertools.zip_longest(*traces.values()):
        for name, ev in zip(traces, evs):
            if ev is not None:
                tickets[name].append(daemon.submit(name, ev))
        if yield_between:
            await asyncio.sleep(0)
    return tickets


def run_daemon(engine, windows, traces, *, queue_limit=None, **kw):
    async def run():
        daemon = AllocDaemon(engine, queue_limit=queue_limit)
        for name, win in windows.items():
            daemon.add_tenant(name, win, **kw)
        await daemon.start()
        tickets = await submit_interleaved(daemon, traces)
        await daemon.shutdown(drain=True)
        return daemon, tickets
    return asyncio.run(run())


# --------------------------------------------------------------------------
# The daemon within the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_daemon_conformant_random_traces(seed):
    traces = {f"t{i}": trace(seed + 31 * i, i, 16) for i in range(3)}
    daemon, _ = run_daemon(make_engine(3),
                           {f"t{i}": make_window(i) for i in range(3)},
                           traces)
    for i in range(3):
        assert_reports_bitequal(daemon.reports(f"t{i}"),
                                offline_replay(i, traces[f"t{i}"]))
    rep = daemon.report()
    assert rep["rejected"] == 0
    assert rep["events_folded"] == sum(len(t) for t in traces.values())


def test_daemon_conformant_open_loop_schedules():
    engine = make_engine(4)
    traces = {f"t{i}": trace(11 + i, i, 8) for i in range(2)}

    async def run(times):
        daemon = AllocDaemon(engine, queue_limit=64)
        for i in range(2):
            daemon.add_tenant(f"t{i}", make_window(i))
        await daemon.start()
        await drive_open_loop(daemon, interleave_traces(traces, times))
        await daemon.shutdown(drain=True)
        return daemon

    for times in (poisson_times(3, 16, rate=5000.0),
                  flash_crowd_times(3, 16, rate=5000.0)):
        daemon = asyncio.run(run(times))
        assert daemon.rejected == 0
        for i in range(2):
            assert_reports_bitequal(daemon.reports(f"t{i}"),
                                    offline_replay(i, traces[f"t{i}"], 4))
        rep = daemon.report()
        assert rep["admission_p99_ms"] >= rep["admission_p50_ms"] >= 0.0


def test_resident_tenants_conformant():
    """``residency="resident"`` makes each window resident at registration
    on the engine's mesh; its flushes equal the round-trip replay."""
    mesh = lane_mesh(devices=["cpu"] * 2)
    traces = {f"t{i}": trace(5 + i, i, 12) for i in range(2)}
    daemon, _ = run_daemon(make_engine(3, mesh=mesh),
                           {f"t{i}": make_window(i) for i in range(2)},
                           traces)
    for i in range(2):
        assert daemon._tenants[f"t{i}"].session.window.is_resident
        assert_reports_bitequal(daemon.reports(f"t{i}"),
                                offline_replay(i, traces[f"t{i}"]))


def test_backpressure_rejects_with_penalty_and_stays_conformant():
    engine = make_engine(4)
    events = [arrival(s) for s in range(12)]

    async def run():
        daemon = AllocDaemon(engine, queue_limit=5)
        daemon.add_tenant("t0", make_window(0))
        await daemon.start()
        tickets = [daemon.submit("t0", ev) for ev in events]
        await daemon.shutdown(drain=True)
        return daemon, tickets

    daemon, tickets = asyncio.run(run())
    rejected = [t for t in tickets if not t.accepted]
    assert len(rejected) == len(events) - 5
    want_cost = sum(rejection_penalty(t.event) for t in rejected)
    assert want_cost > 0.0
    assert daemon.rejection_cost == pytest.approx(want_cost)
    assert all(t.report is None and t.penalty > 0.0 for t in rejected)
    assert_reports_bitequal(
        daemon.reports("t0"),
        offline_replay(0, [t.event for t in tickets if t.accepted], 4))


def test_rejection_penalty_values():
    ev = arrival(0)
    assert rejection_penalty(ev) == pytest.approx(
        abs(ev.params["m"]) * abs(ev.params["H_up"]))
    assert rejection_penalty(tt.ClassDeparture(lane=0, slot=0)) == 0.0
    assert rejection_penalty(ev) == jd.rejection_penalty(
        jt.ClassArrival(lane=ev.lane, params=ev.params))


def test_graceful_drain_flushes_partial_epochs():
    traces = {f"t{i}": trace(41 + i, i, 13)[:7] for i in range(2)}
    daemon, tickets = run_daemon(make_engine(4),
                                 {f"t{i}": make_window(i) for i in range(2)},
                                 traces)
    for i in range(2):
        assert_reports_bitequal(daemon.reports(f"t{i}"),
                                offline_replay(i, traces[f"t{i}"], 4))
        assert len(daemon.reports(f"t{i}")) == 2
        assert all(t.report is not None and not t.cancelled
                   for t in tickets[f"t{i}"])


def test_abort_cancels_and_keeps_flushed_prefix():
    engine = make_engine(4)
    events = trace(77, 0, 11)

    async def run():
        daemon = AllocDaemon(engine, queue_limit=None)
        daemon.add_tenant("t0", make_window(0))
        await daemon.start()
        tickets = [daemon.submit("t0", ev) for ev in events]
        for _ in range(8):
            await asyncio.sleep(0)
        await daemon.shutdown(drain=False)
        return daemon, tickets

    daemon, tickets = asyncio.run(run())
    assert daemon._tenants["t0"].session.pending == ()
    cancelled = [t for t in tickets if t.cancelled]
    delivered = [t for t in tickets if t.report is not None]
    assert len(cancelled) + len(delivered) == len(events)
    assert len(daemon.reports("t0")) >= 1
    assert_reports_bitequal(daemon.reports("t0"),
                            offline_replay(0, events, 4), prefix=True)
    with pytest.raises(RuntimeError):
        daemon.submit("t0", events[0])


def test_idle_daemon_shutdown_is_a_noop():
    daemon, _ = run_daemon(make_engine(), {"t0": make_window(0)}, {})
    assert daemon.reports("t0") == []
    assert daemon._tenants["t0"].session.flushes == 0
    assert daemon.report()["events_per_sec"] == 0.0


def test_due_sessions_flush_tightest_slack_first():
    async def run():
        daemon = AllocDaemon(make_engine(2))
        daemon.add_tenant("loose", make_window(0))
        daemon.add_tenant("tight", make_window(1))
        await daemon.start()
        daemon.submit("loose", arrival(0, E=-100.0))
        daemon.submit("tight", arrival(1, E=-1.0))
        daemon.submit("loose", arrival(2, E=-90.0))
        daemon.submit("tight", arrival(3, E=-50.0))
        await daemon.shutdown(drain=True)
        return daemon

    daemon = asyncio.run(run())
    assert [name for name, _ in daemon.flush_log] == ["tight", "loose"]
    slacks = dict(daemon.flush_log)
    assert slacks["tight"] == pytest.approx(1.0)
    assert slacks["loose"] == pytest.approx(90.0)


def test_round_robin_intake_is_fair_to_quiet_tenants():
    async def run():
        daemon = AllocDaemon(make_engine(1000))
        daemon.add_tenant("chatty", make_window(0))
        daemon.add_tenant("quiet", make_window(1))
        await daemon.start()
        for s in range(24):
            daemon.submit("chatty", arrival(s))
        for s in range(4):
            daemon.submit("quiet", arrival(100 + s))
        await daemon.shutdown(drain=True)
        return daemon

    daemon = asyncio.run(run())
    last_quiet = max(i for i, n in enumerate(daemon.fold_log)
                     if n == "quiet")
    assert last_quiet <= 2 * 4
    assert daemon.fold_log.count("quiet") == 4
    assert daemon.fold_log.count("chatty") == 24


def test_critical_event_preempts_bulk_coalescing():
    async def run():
        daemon = AllocDaemon(make_engine(50, slack=10.0))
        daemon.add_tenant("t0", make_window(0))
        await daemon.start()
        daemon.submit("t0", arrival(0, E=-500.0))
        await asyncio.sleep(0)
        await asyncio.sleep(0)
        assert daemon._tenants["t0"].session.flushes == 0
        daemon.submit("t0", arrival(1, E=-2.0))
        await daemon.shutdown(drain=True)
        return daemon

    daemon = asyncio.run(run())
    assert len(daemon.reports("t0")) == 1


def test_per_tenant_quota_rejections_and_stats():
    engine = make_engine(100)
    events = [arrival(i) for i in range(5)]

    async def run():
        daemon = AllocDaemon(engine, queue_limit=64)
        daemon.add_tenant("capped", make_window(0),
                          quota=te.TenantQuota(max_queued=2))
        daemon.add_tenant("free", make_window(1))
        await daemon.start()
        capped = [daemon.submit("capped", ev) for ev in events]
        free = [daemon.submit("free", ev) for ev in events]
        await daemon.shutdown(drain=True)
        return daemon, capped, free

    daemon, capped, free = asyncio.run(run())
    assert [tk.accepted for tk in capped] == [True, True] + [False] * 3
    assert all(tk.accepted for tk in free)
    stats = daemon.tenant_stats("capped")
    assert stats["submitted"] == 5.0 and stats["rejected"] == 3.0
    assert stats["rejection_cost"] == pytest.approx(
        sum(tk.penalty for tk in capped[2:]))
    assert daemon.rejected == 3 and daemon.submitted == 10
    assert_reports_bitequal(daemon.reports("capped"),
                            offline_replay(0, events[:2], 100))
    assert_reports_bitequal(daemon.reports("free"),
                            offline_replay(1, events, 100))
    with pytest.raises(te.QuotaExceededError):
        engine.open_window(make_window(0),
                           quota=te.TenantQuota(max_lanes=len(NS) - 1))


def test_drain_tenant_is_single_tenant_graceful_drain():
    traces = {"a": [arrival(i) for i in range(5)],
              "b": [arrival(10 + i) for i in range(4)]}

    async def run():
        daemon = AllocDaemon(make_engine(3))
        daemon.add_tenant("a", make_window(0))
        daemon.add_tenant("b", make_window(1))
        await daemon.start()
        for name, evs in traces.items():
            for ev in evs:
                daemon.submit(name, ev)
        daemon.drain_tenant("a")
        reports_a = list(daemon.reports("a"))
        await daemon.shutdown(drain=True)
        return daemon, reports_a

    daemon, reports_a = asyncio.run(run())
    assert_reports_bitequal(reports_a, offline_replay(0, traces["a"]))
    assert_reports_bitequal(daemon.reports("b"), offline_replay(1, traces["b"]))


# --------------------------------------------------------------------------
# Over a socket, within the port
# --------------------------------------------------------------------------

async def torch_server(flush_k=3, queue_limit=256):
    server = AllocServer(AllocDaemon(make_engine(flush_k),
                                     queue_limit=queue_limit))
    await server.start()
    return server


async def drive_client(client, tenant_lanes, traces, quota=None):
    """Register every tenant, offer the traces interleaved, drain; returns
    the client-side reports by tenant."""
    for name, lns in tenant_lanes.items():
        await client.register_tenant(name, lns, n_max=N_MAX, quota=quota)
    tickets = []
    for k in range(max(len(t) for t in traces.values())):
        for name in tenant_lanes:
            if k < len(traces[name]):
                tickets.append(client.offer(name, traces[name][k]))
        await asyncio.sleep(0)
    acks = [await tk.ack() for tk in tickets]
    await client.drain()
    for tk in tickets:
        await tk.result()
    return acks, {name: list(client.reports(name)) for name in tenant_lanes}


@pytest.mark.parametrize("seed", [0, 1])
def test_socket_tenants_conformant(seed):
    names = [f"t{i}" for i in range(2)]
    traces = {nm: trace(seed * 100 + i * 7, i, 9)
              for i, nm in enumerate(names)}

    async def run():
        server = await torch_server()
        client = await AllocClient.connect(*server.address)
        acks, got = await drive_client(
            client, {nm: lanes(i)[1] for i, nm in enumerate(names)}, traces,
            quota=te.TenantQuota(max_queued=64))
        daemon_side = {nm: list(server.daemon.reports(nm)) for nm in names}
        await client.close()
        await server.close()
        return acks, got, daemon_side

    acks, got, daemon_side = asyncio.run(run())
    assert all(acks)
    for i, nm in enumerate(names):
        want = offline_replay(i, traces[nm])
        assert_reports_bitequal(got[nm], want)
        assert_reports_bitequal(daemon_side[nm], want)


def test_socket_quota_flush_request_and_disconnect():
    events = [arrival(i) for i in range(6)]

    async def run():
        server = await torch_server(flush_k=100)
        client = await AllocClient.connect(*server.address)
        await client.register_tenant("q", lanes(4)[1], n_max=N_MAX,
                                     quota=te.TenantQuota(max_queued=2))
        acks = [await client.offer("q", ev).ack() for ev in events]
        forced = await client.flush("q")
        await client.register_tenant("d", lanes(3)[1], n_max=N_MAX)
        for ev in events[:2]:
            assert await client.offer("d", ev).ack() is True
        with pytest.raises(tw.RemoteError):
            await client.offer("ghost", events[0]).ack()
        await client.close()           # abrupt: no drain frame
        daemon = server.daemon
        for _ in range(500):
            if daemon.reports("d") and not daemon._tenants["d"].queued:
                break
            await asyncio.sleep(0.01)
        dropped = list(daemon.reports("d"))
        await server.close()
        return acks, forced, dropped

    acks, forced, dropped = asyncio.run(run())
    assert acks == [True, True] + [False] * 4
    want = list(make_engine(100).open_window(
        ts.AdmissionWindow(lanes(4)[1], n_max=N_MAX)).stream(events[:2]))
    assert_reports_bitequal([forced], want)
    assert_reports_bitequal(dropped, list(make_engine(100).open_window(
        ts.AdmissionWindow(lanes(3)[1], n_max=N_MAX)).stream(events[:2])))


# --------------------------------------------------------------------------
# Across stacks
# --------------------------------------------------------------------------

def test_jax_client_drives_a_torch_server():
    names = ["t0", "t1"]
    jl = {nm: lanes(20 + i)[0] for i, nm in enumerate(names)}
    traces = {nm: js.sample_event_trace(
        60 + i, js.AdmissionWindow(jl[nm], n_max=N_MAX), 9)
        for i, nm in enumerate(names)}

    async def run():
        server = await torch_server()
        client = await jc.AllocClient.connect(*server.address)
        acks, got = await drive_client(client, jl, traces)
        daemon_side = {nm: list(server.daemon.reports(nm)) for nm in names}
        await client.close()
        await server.close()
        return acks, got, daemon_side

    acks, got, daemon_side = asyncio.run(run())
    assert all(acks)
    for nm in names:
        received = [tw.decode_scenario(jw.encode_scenario(s), device="cpu")
                    for s in jl[nm]]
        events = [tw.decode_event(jw.encode_event(ev)) for ev in traces[nm]]
        own = list(make_engine(3).open_window(
            ts.AdmissionWindow(received, n_max=N_MAX)).stream(events))
        assert_reports_bitequal(got[nm], own)
        assert_reports_bitequal(daemon_side[nm], own)
        other = list(jax_engine(3).open_window(
            js.AdmissionWindow(jl[nm], n_max=N_MAX)).stream(traces[nm]))
        assert_reports_close(got[nm], other)


def test_torch_client_drives_a_jax_server():
    names = ["t0", "t1"]
    tl = {nm: lanes(30 + i)[1] for i, nm in enumerate(names)}
    traces = {nm: ts.sample_event_trace(
        70 + i, ts.AdmissionWindow(tl[nm], n_max=N_MAX), 9)
        for i, nm in enumerate(names)}

    async def run():
        server = jsrv.AllocServer(jd.AllocDaemon(jax_engine(3),
                                                 queue_limit=256))
        await server.start()
        client = await AllocClient.connect(*server.address)
        acks, got = await drive_client(client, tl, traces)
        await client.close()
        await server.close()
        return acks, got

    acks, got = asyncio.run(run())
    assert all(acks)
    for nm in names:
        received = [jw.decode_scenario(tw.encode_scenario(s))
                    for s in tl[nm]]
        events = [jw.decode_event(tw.encode_event(ev)) for ev in traces[nm]]
        own = list(jax_engine(3).open_window(
            js.AdmissionWindow(received, n_max=N_MAX)).stream(events))
        assert_reports_bitequal(got[nm], own)
        other = list(make_engine(3).open_window(
            ts.AdmissionWindow(tl[nm], n_max=N_MAX)).stream(traces[nm]))
        assert_reports_close(got[nm], other)


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [["--arrival", "flash"],
                                   ["--resident", "--devices", "2"]])
def test_launch_allocd_main_on_the_cpu(extra, capsys):
    rep = allocd_cli.main(["--device", "cpu", "--tenants", "2", "--lanes",
                           "2", "--classes", "4", "--events", "10",
                           "--rate", "2000", "--flush-every", "4",
                           "--conformance"] + extra)
    out = capsys.readouterr().out
    assert "conformance: OK (2 tenants" in out
    assert rep["rejected"] == 0 and rep["events_folded"] == 20


def test_launch_allocd_windows_are_seeded_per_lane():
    args = type("Args", (), {"seed": 4, "lanes": 2, "classes": 3,
                             "device": "cpu"})()
    a, b = allocd_cli.make_window(args, 0), allocd_cli.make_window(args, 0)
    c = allocd_cli.make_window(args, 1)
    for f in dataclasses.fields(a.batch.scenarios):
        assert torch.equal(getattr(a.batch.scenarios, f.name),
                           getattr(b.batch.scenarios, f.name))
    assert not torch.equal(a.batch.scenarios.A, c.batch.scenarios.A)
    want = ts.AdmissionWindow(
        [allocd_cli.sample_scenario(class_generator(4, 97 + lane), 3,
                                    capacity_factor=1.3, device="cpu")
         for lane in range(2)], n_max=6)
    assert torch.equal(c.batch.scenarios.A, want.batch.scenarios.A)
