"""Fleet capacity-planner launcher: sweep a design space, print the frontier.

    PYTHONPATH=src python -m repro_torch.launch.plan --classes 4 \
        --profile bursty --cluster-sizes 800,2000,5000 \
        --tiers small:1:6,large:2:10 --deadline-scales 0.8,1.0,1.2

Counterpart of ``repro.launch.plan``, with the same flags plus ``--device``
(default ``cuda``; ``--device cpu`` runs on the CPU).  Expands the
:class:`repro_torch.core.planning.PlanSpec` grid, solves every candidate
through the engine's batched Algorithm 4.1 path in fixed-width chunks, and
prints the cheapest feasible design plus the (cost, penalty) Pareto
frontier.  ``--shard`` / ``--devices N`` lane-shard the chunks over
``lane_mesh(N)`` on the card, or over ``lane_mesh(devices=["cpu"] * N)``
with ``--device cpu``; ``--warm-start`` seeds each deadline step from the
previous step's equilibrium; ``--json PATH`` writes the frontier report.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core import (PlanSpec, SolverConfig, VMTier, lane_mesh,
                              solve_plan)
from repro_torch.core.traces import ARRIVAL_PROFILES
from repro_torch.utils import resolve_device


def parse_tier(text: str) -> VMTier:
    """Parse one ``name:slots:price`` tier spec."""
    parts = text.split(":")
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(
            f"tier {text!r} is not name:slots:price")
    return VMTier(parts[0], float(parts[1]), float(parts[2]))


def parse_floats(text: str) -> tuple:
    """Parse a comma-separated float list."""
    return tuple(float(x) for x in text.split(",") if x)


def build_spec(args) -> PlanSpec:
    """The PlanSpec an argparse namespace describes."""
    return PlanSpec(
        n_classes=args.classes, profile=args.profile, rate=args.rate,
        trace_events=args.trace_events,
        cluster_sizes=parse_floats(args.cluster_sizes),
        vm_tiers=tuple(parse_tier(t) for t in args.tiers.split(",") if t),
        deadline_scales=parse_floats(args.deadline_scales),
        penalty_scales=parse_floats(args.penalty_scales),
        seed=args.seed)


def build_mesh(args, device):
    """The lane mesh ``--shard`` / ``--devices`` ask for on ``device``, or
    None: the card's devices, or the CPU repeated ``--devices`` times."""
    if not (args.shard or args.devices):
        return None
    if device.type == "cpu":
        return lane_mesh(devices=["cpu"] * (args.devices or 1))
    return lane_mesh(args.devices)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--profile", choices=sorted(ARRIVAL_PROFILES),
                    default="poisson",
                    help="workload-trace profile the fleet is sized for")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="mean arrival rate [events/s] of the sizing trace")
    ap.add_argument("--trace-events", type=int, default=512)
    ap.add_argument("--cluster-sizes", type=str, default="1500,3000,6000",
                    help="comma-separated candidate capacities R")
    ap.add_argument("--tiers", type=str, default="small:1:6,large:2:10",
                    help="comma-separated name:slots:price VM tiers")
    ap.add_argument("--deadline-scales", type=str, default="0.8,1.0,1.2",
                    help="comma-separated deadline-tightness multipliers")
    ap.add_argument("--penalty-scales", type=str, default="1.0",
                    help="comma-separated rejection-penalty multipliers")
    ap.add_argument("--chunk", type=int, default=64,
                    help="candidates per solve dispatch (results are "
                         "chunk-independent bit-for-bit)")
    ap.add_argument("--warm-start", action="store_true",
                    help="seed each deadline step from the previous "
                         "step's equilibrium")
    ap.add_argument("--shard", action="store_true",
                    help="lane-shard chunks over a device mesh")
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size for --shard (default: every card; "
                         "1 with --device cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=str, default=None, metavar="PATH",
                    help="write the frontier report as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the plan is solved (default the card)")
    args = ap.parse_args(argv)

    spec = build_spec(args)
    device = resolve_device(args.device)
    mesh = build_mesh(args, device)
    cfg = SolverConfig(mesh=mesh)
    report = solve_plan(spec, config=cfg, chunk=args.chunk,
                        warm_start=args.warm_start, device=device)

    n_feas = int(report.feasible.sum())
    print(f"[plan] {report.n_candidates} candidates "
          f"({'x'.join(map(str, spec.grid_shape))} grid, "
          f"profile={spec.profile}) solved in {report.elapsed_s:.2f}s on "
          f"{device} ({report.n_chunks} chunks of {report.chunk}"
          f"{', warm-start' if report.warm_start else ''}"
          f"{', sharded' if mesh is not None else ''})")
    print(f"[plan] {n_feas} feasible / "
          f"{report.n_candidates - n_feas} infeasible")

    cheapest = report.cheapest_feasible()
    if cheapest is None:
        print("[plan] no feasible design in this space — grow the cluster "
              "axis or relax deadlines")
    else:
        p = report.point(cheapest)
        print(f"[plan] cheapest feasible design: R={p['cluster_size']:.0f} "
              f"tier={p['tier']} deadline_scale={p['deadline_scale']} "
              f"penalty_scale={p['penalty_scale']} -> "
              f"cost {p['cost']:.1f} penalty {p['penalty']:.1f}")

    frontier = report.pareto_frontier()
    print(f"[plan] Pareto frontier ({frontier.size} point(s)):")
    for i in frontier:
        p = report.point(int(i))
        print(f"    #{p['index']:>4} R={p['cluster_size']:>7.0f} "
              f"tier={p['tier']:<8} dl={p['deadline_scale']:<4} "
              f"pen_scale={p['penalty_scale']:<4} cost={p['cost']:>10.1f} "
              f"penalty={p['penalty']:>10.1f}")

    if args.json:
        payload = report.to_json()
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"[plan] wrote {args.json}")
    return report


if __name__ == "__main__":
    main()
