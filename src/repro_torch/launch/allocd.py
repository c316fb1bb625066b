"""Admission daemon launcher: multi-tenant event load + throughput reporting.

    PYTHONPATH=src python -m repro_torch.launch.allocd --tenants 3 \
        --lanes 3 --classes 4 --events 24 --arrival poisson --rate 500 \
        --conformance

Counterpart of ``repro.launch.allocd``, with the same flags plus
``--device`` (default ``cuda``; ``--device cpu`` runs on the CPU).  Builds
one CapacityEngine, registers N tenant windows with the AllocDaemon, drives
per-tenant random event traces open-loop on an arrival schedule of
:data:`~repro_torch.core.traces.ARRIVAL_PROFILES`, and reports sustained
events/sec plus p50/p99 admission latency.  ``--conformance`` replays every
tenant's trace through an identically initialised offline
``WindowSession.stream`` and asserts the daemon's flush-boundary equilibria
are bit-equal.  ``--resident`` / ``--devices N`` put the tenants on
``lane_mesh(N)`` on the card, or on ``lane_mesh(devices=["cpu"] * N)`` with
``--device cpu``.

Server mode (the wire transport):

    PYTHONPATH=src python -m repro_torch.launch.allocd \
        --listen 127.0.0.1:8753

serves the daemon over the length-prefixed JSON-frame protocol of
``repro_torch.serving.wire`` instead of driving synthetic local tenants;
remote processes register tenants and submit events with an
``AllocClient`` of either package.  ``--quota-events`` / ``--quota-lanes``
set the default per-tenant admission budget applied to wire tenants that
register without one.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses

import numpy as np

from repro_torch.core import (AdmissionWindow, CapacityEngine, FlushPolicy,
                              Policies, RoundingPolicy, SolverConfig,
                              lane_mesh, sample_event_trace, sample_scenario)
from repro_torch.core.engine import TenantQuota
from repro_torch.core.planning import class_generator
from repro_torch.serving.allocd import (ARRIVAL_PROFILES, AllocDaemon,
                                        drive_open_loop, interleave_traces)
from repro_torch.serving.server import AllocServer
from repro_torch.utils import resolve_device


def _device(args):
    return resolve_device(getattr(args, "device", "cuda"))


def make_engine(args):
    flush = (FlushPolicy.deadline(args.deadline_slack,
                                  max_events=args.flush_every)
             if args.deadline_slack is not None
             else FlushPolicy(max_events=args.flush_every))
    resident = getattr(args, "resident", False)
    devices = getattr(args, "devices", None)
    device = _device(args)
    mesh = None
    if resident or devices:
        mesh = (lane_mesh(devices=["cpu"] * (devices or 1))
                if device.type == "cpu" else lane_mesh(devices))
    return CapacityEngine(
        SolverConfig(mesh=mesh,
                     residency="resident" if resident else "round-trip"),
        Policies(flush=flush,
                 rounding=RoundingPolicy(enabled=args.round)),
        device=device)


def make_window(args, tenant: int) -> AdmissionWindow:
    """Tenant ``tenant``'s window: lane ``l`` drawn from
    ``class_generator(args.seed, tenant * 97 + l)``."""
    lanes = [sample_scenario(class_generator(args.seed, tenant * 97 + lane),
                             args.classes, capacity_factor=1.3,
                             device=_device(args))
             for lane in range(args.lanes)]
    return AdmissionWindow(lanes, n_max=2 * args.classes)


def make_traces(args):
    return {f"tenant-{t}": sample_event_trace(args.seed + 7919 * t,
                                              make_window(args, t),
                                              args.events)
            for t in range(args.tenants)}


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def assert_reports_bitequal(name, got, want):
    """Every flush report of ``got`` equals ``want``'s bit for bit: each
    field of the fractional ``Solution``, and the mask."""
    assert len(got) == len(want), \
        f"{name}: {len(got)} flushes vs offline {len(want)}"
    for i, (a, b) in enumerate(zip(got, want)):
        for f in dataclasses.fields(a.fractional):
            x, y = _host(getattr(a.fractional, f.name)), \
                _host(getattr(b.fractional, f.name))
            assert x.dtype == y.dtype and x.shape == y.shape and \
                x.tobytes() == y.tobytes(), \
                f"{name}: flush {i} diverged from offline replay in {f.name}"
        np.testing.assert_array_equal(_host(a.mask), _host(b.mask))


async def run_daemon(engine, args, traces):
    daemon = AllocDaemon(engine, queue_limit=args.queue_limit)
    for t in range(args.tenants):
        daemon.add_tenant(f"tenant-{t}", make_window(args, t))
    total = sum(len(tr) for tr in traces.values())
    times = ARRIVAL_PROFILES[args.arrival](args.seed, total, args.rate)
    schedule = interleave_traces(traces, times)
    await daemon.start()
    tickets = await drive_open_loop(daemon, schedule)
    await daemon.shutdown(drain=True)
    return daemon, tickets


async def run_server(engine, args):
    daemon = AllocDaemon(engine, queue_limit=args.queue_limit)
    quota = None
    if args.quota_events is not None or args.quota_lanes is not None:
        quota = TenantQuota(max_queued=args.quota_events,
                            max_lanes=args.quota_lanes)
    host, _, port = args.listen.rpartition(":")
    server = AllocServer(daemon, host=host or "127.0.0.1", port=int(port),
                         default_quota=quota)
    await server.start()
    print(f"[allocd] listening on {server.address[0]}:{server.address[1]} "
          f"(queue_limit={args.queue_limit}, default quota="
          f"{quota or 'none'}, device {engine.device})", flush=True)
    try:
        await server._server.serve_forever()
    except asyncio.CancelledError:
        pass
    finally:
        await server.close(drain=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--listen", type=str, default=None, metavar="HOST:PORT",
                    help="serve the daemon over the wire protocol instead "
                         "of driving local synthetic tenants")
    ap.add_argument("--quota-events", type=int, default=None,
                    help="default TenantQuota.max_queued for wire tenants "
                         "registering without a quota")
    ap.add_argument("--quota-lanes", type=int, default=None,
                    help="default TenantQuota.max_lanes for wire tenants "
                         "registering without a quota")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--classes", type=int, default=5)
    ap.add_argument("--events", type=int, default=32,
                    help="events per tenant")
    ap.add_argument("--arrival", choices=sorted(ARRIVAL_PROFILES),
                    default="poisson")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="open-loop arrival rate [events/s]")
    ap.add_argument("--flush-every", type=int, default=8)
    ap.add_argument("--deadline-slack", type=float, default=None,
                    help="enable FlushPolicy.deadline with this slack [s]")
    ap.add_argument("--queue-limit", type=int, default=4096)
    ap.add_argument("--resident", action="store_true",
                    help="keep tenant window state resident on a lane mesh "
                         "across flushes (SolverConfig(residency="
                         "'resident'))")
    ap.add_argument("--devices", type=int, default=None,
                    help="lane-mesh size for --resident / sharded solves "
                         "(default: every card; 1 with --device cpu)")
    ap.add_argument("--round", action="store_true",
                    help="run Algorithm 4.2 integerization at every flush")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conformance", action="store_true",
                    help="assert bit-equality against offline replays")
    ap.add_argument("--device", default="cuda",
                    help="where the tenants' windows live and are solved "
                         "(default the card)")
    args = ap.parse_args(argv)

    if args.listen is not None:
        try:
            asyncio.run(run_server(make_engine(args), args))
        except KeyboardInterrupt:
            pass
        return None

    engine = make_engine(args)
    traces = make_traces(args)
    daemon, _ = asyncio.run(run_daemon(engine, args, traces))
    rep = daemon.report()

    total = int(rep["events_folded"])
    print(f"[allocd] {args.arrival}: {rep['submitted']:.0f} events, "
          f"{args.tenants} tenants on {engine.device} -> folded {total} in "
          f"{rep['elapsed_s']:.2f}s ({rep['events_per_sec']:.1f} ev/s, "
          "first flushes included)")
    print(f"[allocd] admission latency p50 {rep['admission_p50_ms']:.1f} ms"
          f" / p99 {rep['admission_p99_ms']:.1f} ms; "
          f"flushes {rep['flushes']:.0f}; rejected {rep['rejected']:.0f} "
          f"(penalty {rep['rejection_cost']:.2f})")

    if args.conformance:
        if rep["rejected"]:
            print("[allocd] conformance: SKIPPED (rejections under "
                  "backpressure change the delivered trace)")
        else:
            for name, trace in traces.items():
                t = int(name.split("-")[1])
                offline = engine.open_window(make_window(args, t))
                want = list(offline.stream(trace))
                assert_reports_bitequal(name, daemon.reports(name), want)
            print(f"[allocd] conformance: OK ({args.tenants} tenants "
                  "bit-equal to offline replay)")
    return rep


if __name__ == "__main__":
    main()
