"""The dry run: cost every (arch x shape) cell on the production meshes
(16 x 16 single-pod, 2 x 16 x 16 multi-pod) and write its roofline terms
to JSON (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 8]

JAX lowers and compiles each cell against ``ShapeDtypeStruct``s on 512
forced host devices.  The port runs each cell's step eagerly on meta
tensors (``configs.specs.input_specs``, ``init_params(cfg, None,
device="meta")``) through the route the card takes, the hand-written
kernels' dispatcher operators included, and counts what is dispatched
(``analysis.StepCounter``): no card, no memory, no launch.  The mesh is
``make_production_mesh(devices=["meta"] * n)``, so the model takes the
mesh's value-changing branches (the GQA repeat, the per-rank MoE capacity,
the sequence-sharded decode) as it would on n cards.

A record has JAX's fields.  A mesh repeats one device and every tensor
lies whole on it, so the counts are global: ``global_flops`` /
``global_bytes`` hold them, and ``per_device`` is their even split over
the mesh's ``chips`` (``per_device_is``); with no scan to correct,
``raw_flops_uncorrected`` is the same count.  ``memory`` is the
live-storage tracker's global figures for the prefill / decode step, and
for the train step its microbatch loop and update as ``_train_memory``
composes them from the tracker's runs of the two cost units (the whole
step tracked where M = 1).  The train cost is M x one microbatch plus the
optimizer, as in JAX.  No collective runs, so
``coll_bytes`` and ``t_collective`` are null with a reason: writing 0
would understate the term (ROADMAP item 26 brings the collectives).
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from pathlib import Path

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.specs import cell_is_live, input_specs
from repro_torch.launch import analysis as an
from repro_torch.launch.bodies import scan_bodies
from repro_torch.launch.mesh import dist_for, make_production_mesh
from repro_torch.launch.steps import (jit_decode_step, jit_grad_step_micro,
                                      jit_opt_step, jit_prefill_step,
                                      jit_train_step)
from repro_torch.models import init_params, layers
from repro_torch.models.config import ALL_SHAPES, SHAPES_BY_NAME
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.utils import tree_leaves

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# optimizer state tier per arch (what makes the big ones fit — DESIGN.md 5)
OPT_TIER = {"kimi-k2-1t-a32b": "int8", "jamba-v0.1-52b": "bf16",
            "qwen3-32b": "bf16", "deepseek-moe-16b": "bf16"}

NO_COLLECTIVE = ("not measured: a mesh repeats one device and no collective "
                 "runs; collectives across cards are ROADMAP item 26, and 0 "
                 "would understate the term")


def count_params(params):
    return sum(math.prod(x.shape) for x in tree_leaves(params))


def active_params(cfg, total):
    if cfg.moe is None:
        return total
    n_moe = sum(1 for _, f in cfg.layer_kinds() if f == "moe")
    per_layer_routed = cfg.moe.n_experts * 3 * cfg.d_model * cfg.moe.d_ff_expert
    used = cfg.moe.top_k * 3 * cfg.d_model * cfg.moe.d_ff_expert
    return total - n_moe * (per_layer_routed - used)


def serving_fsdp(params, mesh) -> bool:
    """The serving policy (EXPERIMENTS §Perf P3): TP-only weights when they
    fit replicated over 'data' (FSDP gathers per decoded token are pure
    waste); the sharding strategy is per shape kind, not per arch."""
    tp = mesh.shape.get("model", 1)
    return count_params(params) * 2 / tp > 8e9


def _train_memory(micro, update, params, batch):
    """The train step's memory at ``cfg.grad_accum`` M >= 2 microbatches,
    from the tracker's runs of its two cost units (``micro``: one
    microbatch's grad step; ``update``: the optimizer step), as
    ``steps.make_train_step`` holds its storages: beside the parameters,
    the optimizer state and the batch, (a) the f32 gradient accumulators
    while a microbatch's step runs, (b) the accumulators and their average
    at the division by M, (c) the average while the update runs.  Tested
    against the tracked step itself (``tests/test_torch_dryrun.py``); the
    step's 0-d scalars are left out."""
    grad_bytes = sum(t.numel() * 4 for t in tree_leaves(params))
    batch_bytes = sum(t.untyped_storage().nbytes() for t in batch.values())
    # the update's arguments are the parameters, the state and the average
    args = update.argument_bytes - grad_bytes + batch_bytes
    peak = max(args + grad_bytes + micro.peak_bytes - micro.argument_bytes,
               args + 2 * grad_bytes,
               batch_bytes + update.peak_bytes)
    return {"argument_gb": args / 1e9,
            "output_gb": update.output_bytes / 1e9,
            "temp_gb": (peak - args - update.output_bytes) / 1e9,
            "alias_gb": 0.0,
            "peak_gb": peak / 1e9}


@dataclass
class Counts:
    """What a cost unit's ``analysis.StepCounter`` counted (picklable:
    the units of ``--jobs`` run in worker processes)."""
    flops: int
    bytes: int
    argument_bytes: int
    peak_bytes: int
    output_bytes: int
    seconds: float

    @classmethod
    def of(cls, fn, *args):
        counter = an.StepCounter()
        t0 = time.time()
        counter.run(fn, *args)
        return cls(counter.flops, counter.bytes, counter.argument_bytes,
                   counter.peak_bytes, counter.output_bytes,
                   time.time() - t0)

    def cost(self):
        return an.CostSummary(float(self.flops), float(self.bytes))


def _cell_setup(arch_id, shape_name, multi_pod, cfg_override):
    """(shape, cfg, mesh, params, dist, specs) of a live cell, or its
    skipped record."""
    shape = SHAPES_BY_NAME[shape_name]
    cfg = cfg_override or get_config(arch_id)
    live, why = cell_is_live(cfg, shape)
    if not live:
        return {"arch": arch_id, "shape": shape_name, "status": "skipped",
                "reason": why}
    if shape_name == "long_500k":
        cfg = cfg.replace(kv_cache_seq_shard=True)
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)
    params = init_params(cfg, None, device="meta")
    fsdp = cfg.fsdp
    if cfg_override is None and shape.kind != "train":
        fsdp = serving_fsdp(params, mesh)
    return shape, cfg, mesh, params, dist_for(mesh, fsdp=fsdp), \
        input_specs(cfg, shape)


def _parts(shape, cfg, body_correction):
    """A live cell's cost units: train, one microbatch's grad step and the
    update (and, at M = 1, the whole step for its memory); otherwise the
    step; then the layer groups."""
    if shape.kind == "train":
        parts = ["micro", "update"] + (["whole"] if cfg.grad_accum <= 1
                                       else [])
    else:
        parts = ["step"]
    return parts + (["bodies"] if body_correction else [])


def cost_unit(arch_id, shape_name, part, *, multi_pod=False,
              cfg_override=None):
    """One cost unit of a live cell (:func:`_parts`): ``Counts``, or for
    ``bodies`` the layer groups' records."""
    shape, cfg, _, params, dist, specs = _cell_setup(
        arch_id, shape_name, multi_pod, cfg_override)
    # the M-RoPE band map is built once a device and process: every unit
    # counts its copy to the device, as a fresh process does, whatever ran
    # before it in this one
    layers._mrope_streams.cache_clear()
    M = cfg.grad_accum if shape.kind == "train" else 1
    if part == "bodies":
        return [{"name": g["name"], "trips": g["trips"], "microbatches": M,
                 "flops": c.flops, "bytes": c.bytes_accessed,
                 "coll_bytes": None}
                for g in scan_bodies(cfg, dist, shape, params,
                                     cache=specs.get("cache"))
                for c in (g["cost"](),)]
    if shape.kind == "train":
        oc = OptConfig(state_dtype=OPT_TIER.get(arch_id, "f32"))
        if part == "micro":
            step, args = jit_grad_step_micro(cfg, dist, params,
                                             specs["batch"], M)
            return Counts.of(step, *args)
        opt = adamw_init(params, oc)
        if part == "update":
            step, args = jit_opt_step(cfg, dist, oc, params, opt)
            return Counts.of(step, *args)
        return Counts.of(jit_train_step(cfg, dist, oc, params, opt,
                                        specs["batch"]), params, opt,
                         specs["batch"])
    if shape.kind == "prefill":
        return Counts.of(jit_prefill_step(cfg, dist, params, specs["batch"]),
                         params, specs["batch"])
    return Counts.of(jit_decode_step(cfg, dist, params, specs["cache"]),
                     params, specs["cache"], specs["token"], specs["pos"])


def lower_cell(arch_id, shape_name, *, multi_pod=False, body_correction=True,
               cfg_override=None, verbose=True, units=None):
    """Cost one cell on meta tensors; returns the result record (dict).

    ``body_correction`` keeps JAX's name: it records the layer groups'
    costs (``bodies.scan_bodies``), which the eager count needs no
    correction by.  ``units`` maps a unit (:func:`_parts`) to its
    :func:`cost_unit` result where ``main``'s workers computed it; the
    rest are computed here."""
    setup = _cell_setup(arch_id, shape_name, multi_pod, cfg_override)
    if isinstance(setup, dict):
        return setup
    shape, cfg, mesh, params, _, specs = setup
    units = dict(units or {})
    for part in _parts(shape, cfg, body_correction):
        if part not in units:
            units[part] = cost_unit(arch_id, shape_name, part,
                                    multi_pod=multi_pod,
                                    cfg_override=cfg_override)

    # train: cost = M x (one microbatch's fwd + bwd) + the optimizer
    M = cfg.grad_accum if shape.kind == "train" else 1
    body_records = []
    if shape.kind == "train":
        micro, update = units["micro"], units["update"]
        cost = micro.cost().scaled(M) + update.cost()
        body_records.append({"name": "opt", "trips": 1,
                             "flops": update.flops, "bytes": update.bytes,
                             "coll_bytes": None})
        mem = (an.memory_summary(units["whole"]) if M <= 1 else
               _train_memory(micro, update, params, specs["batch"]))
        seconds = micro.seconds + update.seconds
    else:
        cost = units["step"].cost()
        mem = an.memory_summary(units["step"])
        seconds = units["step"].seconds
    body_records += units.get("bodies", [])
    if verbose:
        print(f"  memory: {mem}")
        print(f"  counted: flops={cost.flops:.4g} "
              f"bytes={cost.bytes_accessed:.4g}")

    chips = math.prod(mesh.devices.shape)
    rf = an.roofline(cost.scaled(1.0 / chips))
    rf = an.Roofline(rf.t_compute, rf.t_memory, None)
    total = count_params(params)
    act = active_params(cfg, total)
    mf = an.model_flops(cfg, shape, total, act)
    rec = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.devices.shape)),
        "status": "ok", "lower_s": round(seconds, 1), "compile_s": None,
        "hardware": an.H100.name,
        "memory": mem,
        "chips": chips,
        "global_flops": cost.flops,
        "global_bytes": cost.bytes_accessed,
        "per_device_is": "the global counts over chips, an even split: the "
                         "mesh repeats one device",
        "per_device": {"flops": cost.flops / chips,
                       "bytes": cost.bytes_accessed / chips,
                       "coll_bytes": None, "coll_by_op": {},
                       "raw_flops_uncorrected": cost.flops / chips},
        "bodies": body_records,
        "roofline": {"t_compute": rf.t_compute, "t_memory": rf.t_memory,
                     "t_collective": None,
                     "t_collective_reason": NO_COLLECTIVE,
                     "bottleneck": rf.bottleneck,
                     "compute_fraction": rf.compute_fraction},
        "params_total": total, "params_active": act,
        "model_flops": mf,
        "useful_ratio": mf / max(cost.flops, 1.0),
    }
    return rec


def _cell(aid, sname, multi_pod, body_correction, units=None):
    """One cell's record; an error becomes an error record (a worker's
    boundary)."""
    try:
        return lower_cell(aid, sname, multi_pod=multi_pod,
                          body_correction=body_correction, verbose=False,
                          units=units)
    except Exception as e:
        return {"arch": aid, "shape": sname, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()}


def _pooled(cells, multi_pod, body_correction, jobs):
    """The cells' records, their cost units computed by ``jobs`` worker
    processes (the train cells' microbatch units first: the longest), each
    cell assembled here once its units are in."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        work = []
        for aid, sname in cells:
            shape = SHAPES_BY_NAME[sname]
            cfg = get_config(aid)
            if cell_is_live(cfg, shape)[0]:
                work += [(aid, sname, part) for part in
                         _parts(shape, cfg, body_correction)]
        work.sort(key=lambda w: w[2] != "micro")
        futures = {w: pool.submit(cost_unit, *w, multi_pod=multi_pod)
                   for w in work}
        for aid, sname in cells:
            units, error = {}, None
            for (a, s, part), fut in futures.items():
                if (a, s) != (aid, sname):
                    continue
                try:
                    units[part] = fut.result()
                except Exception as e:      # the worker's, with its trace
                    error = {"arch": aid, "shape": sname, "status": "error",
                             "error": f"{type(e).__name__}: {e}",
                             "traceback": "".join(
                                 traceback.format_exception(e))}
            yield error or _cell(aid, sname, multi_pod, body_correction,
                                 units)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-body", action="store_true",
                    help="skip the layer groups' costs")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cost units computed at once, each in a worker "
                         "process")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(aid, s.name) for aid in ARCHS for s in ALL_SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    if args.jobs > 1:
        records = _pooled(cells, args.multi_pod, not args.no_body, args.jobs)
    else:
        records = (_cell(aid, sname, args.multi_pod, not args.no_body)
                   for aid, sname in cells)
    failures = _report(records, out_dir, args.multi_pod)
    print(f"[dryrun] done, {failures} failures / {len(cells)} cells")
    return failures


def _report(records, out_dir, multi_pod):
    """Writes and prints each record; returns the number of errors."""
    failures = 0
    for rec in records:
        aid, sname = rec["arch"], rec["shape"]
        print(f"[dryrun] {aid}:{sname}:{'2x16x16' if multi_pod else '16x16'}")
        fn = out_dir / f"{aid}__{sname}__{'multi' if multi_pod else 'single'}.json"
        fn.write_text(json.dumps(rec, indent=1))
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"  -> ok: bottleneck={r['bottleneck']} "
                  f"t=(c {r['t_compute']:.4f}, m {r['t_memory']:.4f}, "
                  f"coll null)s useful={rec['useful_ratio']:.2f} "
                  f"peak_mem={rec['memory']['peak_gb']:.1f}GB (global) "
                  f"counted in {rec['lower_s']}s")
        elif rec["status"] == "skipped":
            print(f"  -> skipped: {rec['reason']}")
        else:
            print(rec["traceback"])
            failures += 1
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
