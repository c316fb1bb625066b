"""Parity of the port's dry run (``repro_torch.launch.dryrun`` and
``repro_torch.launch.bodies``) with ``repro.launch.dryrun``, and what its
counts are held to.

* JAX's pure pieces, exactly, every arch at full size: ``count_params`` and
  ``active_params`` (on ``eval_shape`` trees against meta ones),
  ``OPT_TIER``, the serving-FSDP decision (JAX's own ``lower_cell``, run up
  to the ``dist_for`` call it makes with it), ``model_flops`` of every
  shape and the skipped cells' records.  ``repro.launch.dryrun`` sets
  ``XLA_FLAGS`` when it is imported, so the JAX side runs in a subprocess.
* ``lower_cell`` at reduced configurations (``cfg_override``) for each
  shape kind on the production mesh: JAX's fields, the collective term
  null with its reason, the even per-device split, the train cost M x one
  microbatch plus the update.
* The body identity: the counted step at ``n_layers = L + block_len``
  less the step at ``L`` is the layer group's ``cost()``, FLOPs and bytes
  exactly, in prefill, decode and train for a dense, an RWKV6, an MoE and
  an encoder-decoder configuration and in prefill for the hybrid (train:
  the encoder-decoder's bytes but one accumulation of the frames'
  gradient, which a lone decoder block has no second use to add to).
* The train memory composed from the two cost units against the tracked
  step; ``main``'s record files; a cell assembled from units computed
  apart (``--jobs``) equal to one costed at once.
* The fleet reads the port's records and refuses a null collective term.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.cluster import FleetSimulator, TenantSpec
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.specs import input_specs
from repro_torch.launch import analysis as an
from repro_torch.launch import dryrun
from repro_torch.launch.bodies import scan_bodies
from repro_torch.launch.mesh import dist_for, make_mesh, make_production_mesh
from repro_torch.launch.steps import (jit_grad_step_micro, jit_opt_step,
                                      jit_train_step, make_decode_step,
                                      make_grad_step, make_prefill_step)
from repro_torch.models import init_params
from repro_torch.models.config import ALL_SHAPES, SHAPES_BY_NAME, ShapeConfig
from repro_torch.optim import OptConfig, adamw_init

SRC = str(Path(__file__).resolve().parents[1] / "src")

JAX_SCRIPT = r"""
import json
import repro.launch.dryrun as d          # sets XLA_FLAGS before jax starts
import jax
from repro.configs import ARCH_IDS, get_config
from repro.configs.specs import cell_is_live
from repro.models.config import ALL_SHAPES


class Stop(Exception):
    pass


seen = {}


def dist_for(mesh, *, fsdp):
    seen["fsdp"] = fsdp
    raise Stop


d.dist_for = dist_for
out = {"opt_tier": d.OPT_TIER, "archs": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    params = jax.eval_shape(lambda: d.init_params(cfg, jax.random.PRNGKey(0)))
    total = d.count_params(params)
    act = d.active_params(cfg, total)
    rec = {"total": total, "active": act, "cells": {}}
    for s in ALL_SHAPES:
        cell = {"model_flops": d.an.model_flops(cfg, s, total, act)}
        if not cell_is_live(cfg, s)[0]:
            cell["skipped"] = d.lower_cell(arch, s.name)
        rec["cells"][s.name] = cell
    try:
        d.lower_cell(arch, "prefill_32k")
    except Stop:
        rec["serving_fsdp"] = seen["fsdp"]
    out["archs"][arch] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_dryrun():
    r = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT], capture_output=True, text=True,
        timeout=600,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_policy_and_model_flops_match_jax(jax_dryrun, arch):
    want = jax_dryrun["archs"][arch]
    cfg = get_config(arch)
    params = init_params(cfg, None, device="meta")
    total = dryrun.count_params(params)
    act = dryrun.active_params(cfg, total)
    assert (total, act) == (want["total"], want["active"])
    assert dryrun.OPT_TIER == jax_dryrun["opt_tier"]
    mesh = make_production_mesh(devices=["meta"] * 256)
    assert dryrun.serving_fsdp(params, mesh) == want["serving_fsdp"]
    for s in ALL_SHAPES:
        cell = want["cells"][s.name]
        assert an.model_flops(cfg, s, total, act) == cell["model_flops"]
        if "skipped" in cell:
            assert dryrun.lower_cell(arch, s.name) == cell["skipped"]


# --------------------------------------------------------------------------
# lower_cell at reduced configurations, the production mesh
# --------------------------------------------------------------------------

JAX_FIELDS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s",
              "memory", "per_device", "bodies", "roofline", "params_total",
              "params_active", "model_flops", "useful_ratio"}


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen3-0.6b", "train_4k"), ("qwen3-0.6b", "prefill_32k"),
    ("qwen3-0.6b", "decode_32k"), ("rwkv6-7b", "long_500k")])
def test_lower_cell_at_a_reduced_configuration(arch, shape_name):
    cfg = reduced_config(arch).replace(grad_accum=2)
    rec = dryrun.lower_cell(arch, shape_name, cfg_override=cfg,
                            verbose=False)
    shape = SHAPES_BY_NAME[shape_name]
    assert rec["status"] == "ok" and JAX_FIELDS <= set(rec)
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["roofline"]["t_collective"] is None
    assert "item 26" in rec["roofline"]["t_collective_reason"]
    assert rec["per_device"]["coll_bytes"] is None
    assert rec["per_device"]["flops"] == rec["global_flops"] / 256
    assert rec["per_device"]["bytes"] == rec["global_bytes"] / 256
    assert rec["useful_ratio"] == rec["model_flops"] / rec["global_flops"]
    r = an.roofline(an.CostSummary(rec["global_flops"] / 256,
                                   rec["global_bytes"] / 256))
    assert (rec["roofline"]["t_compute"], rec["roofline"]["t_memory"]) == (
        r.t_compute, r.t_memory)
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    names = [(b["name"], b["trips"]) for b in rec["bodies"]]
    assert names == ([("opt", 1)] if shape.kind == "train" else []) + [
        ("block", cfg.n_layers // cfg.block_len)]
    assert rec["memory"]["peak_gb"] > rec["memory"]["argument_gb"] > 0
    if shape.kind == "train":
        # M x one microbatch plus the update
        mesh = make_production_mesh(devices=["meta"] * 256)
        dist = dist_for(mesh, fsdp=cfg.fsdp)
        params = init_params(cfg, None, device="meta")
        oc = OptConfig(state_dtype=dryrun.OPT_TIER.get(arch, "f32"))
        micro = an.analyze_step(*_unit(jit_grad_step_micro(
            cfg, dist, params, input_specs(cfg, shape)["batch"], 2)))
        upd = an.analyze_step(*_unit(jit_opt_step(
            cfg, dist, oc, params, adamw_init(params, oc))))
        assert rec["global_flops"] == 2 * micro.flops + upd.flops
        assert rec["global_bytes"] == 2 * micro.bytes_accessed \
            + upd.bytes_accessed
        assert rec["bodies"][0]["flops"] == upd.flops


def _unit(step_and_args):
    step, args = step_and_args
    return (step,) + tuple(args)


def test_main_writes_a_record_per_cell(tmp_path):
    """``main`` writes a record a cell (a dead cell its skipped one); a
    cell assembled from units computed apart (as ``--jobs``' workers give
    them) is the cell costed at once."""
    for shape in ("decode_32k", "long_500k"):
        assert dryrun.main(["--arch", "whisper-base", "--shape", shape,
                            "--out-dir", str(tmp_path)]) == 0
    ok, dead = (json.loads((tmp_path / f"whisper-base__{s}__single.json")
                           .read_text()) for s in ("decode_32k", "long_500k"))
    assert ok["status"] == "ok" and dead["status"] == "skipped"
    assert [b["name"] for b in ok["bodies"]] == ["dec_block"]
    units = {part: dryrun.cost_unit("whisper-base", "decode_32k", part)
             for part in ("step", "bodies")}
    apart = dryrun.lower_cell("whisper-base", "decode_32k", verbose=False,
                              units=units)
    ok.pop("lower_s"), apart.pop("lower_s")
    assert apart == ok


# --------------------------------------------------------------------------
# the body identity and the composed train memory
# --------------------------------------------------------------------------

def _step_cost(cfg, shape, dist):
    params = init_params(cfg, None, device="meta")
    specs = input_specs(cfg, shape)
    if shape.kind == "prefill":
        return an.analyze_step(make_prefill_step(cfg, dist), params,
                               specs["batch"])
    if shape.kind == "decode":
        return an.analyze_step(make_decode_step(cfg, dist), params,
                               specs["cache"], specs["token"], 0)
    return an.analyze_step(make_grad_step(cfg, dist), params, specs["batch"])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b",
                                  "deepseek-moe-16b", "jamba-v0.1-52b",
                                  "whisper-base"])
def test_one_more_block_costs_the_body(arch):
    base = reduced_config(arch)
    dist = dist_for(make_mesh((2, 2), ("data", "model"),
                              devices=["meta"] * 4), fsdp=False)
    first = base.moe.first_k_dense if (base.moe and not base.is_encdec) \
        else 0
    bl = 1 if base.is_encdec else base.block_len
    # RWKV6 at T 512 takes the wkv6 operator (chunk 256 < T); Whisper's
    # learned positions stop at 128
    S = {"rwkv6-7b": 512, "whisper-base": 64, "jamba-v0.1-52b": 64}.get(
        arch, 128)
    # (the hybrid's decode and train steps are its slowest to count: the
    # prefill holds its block)
    kinds = ("prefill",) if base.family == "hybrid" else (
        "prefill", "decode", "train")
    for kind in kinds:
        shape = ShapeConfig("cell", kind, S, 2)
        lo, hi = (_step_cost(base.replace(n_layers=n), shape, dist)
                  for n in (first + bl, first + 2 * bl))
        cfg = base.replace(n_layers=first + bl)
        params = init_params(cfg, None, device="meta")
        cache = input_specs(cfg, shape).get("cache")
        group = "dec_block" if cfg.is_encdec else "block"
        body = next(g for g in scan_bodies(cfg, dist, shape, params, cache)
                    if g["name"] == group)["cost"]()
        assert hi.flops - lo.flops == body.flops, kind
        extra = 0
        if kind == "train" and cfg.is_encdec:
            extra = 3 * 2 * S * cfg.d_model * 4     # one f32 add
        assert hi.bytes_accessed - lo.bytes_accessed == \
            body.bytes_accessed + extra, kind


@pytest.mark.parametrize("arch,tier", [("qwen3-0.6b", "int8"),
                                       ("deepseek-moe-16b", "bf16")])
def test_composed_train_memory_is_the_tracked_steps(arch, tier):
    cfg = reduced_config(arch).replace(grad_accum=2)
    shape = ShapeConfig("cell", "train", 32, 4)
    dist = dist_for(make_mesh((2, 2), ("data", "model"),
                              devices=["meta"] * 4), fsdp=False)
    params = init_params(cfg, None, device="meta")
    oc = OptConfig(state_dtype=tier)
    opt = adamw_init(params, oc)
    batch = input_specs(cfg, shape)["batch"]
    whole = an.StepCounter()
    whole.run(jit_train_step(cfg, dist, oc, params, opt, batch), params, opt,
              batch)
    micro, upd = an.StepCounter(), an.StepCounter()
    micro.run(*_unit(jit_grad_step_micro(cfg, dist, params, batch, 2)))
    upd.run(*_unit(jit_opt_step(cfg, dist, oc, params, opt)))
    got = dryrun._train_memory(micro, upd, params, batch)
    want = an.memory_summary(whole)
    assert got["argument_gb"] == want["argument_gb"]
    # the step's 0-d scalars (the loss, its running sum, M, the metrics)
    # are left out of the composition
    for key in ("output_gb", "peak_gb"):
        assert 0 <= want[key] - got[key] <= 1024 / 1e9, key


# --------------------------------------------------------------------------
# the fleet reads the port's records
# --------------------------------------------------------------------------

def _tenant(arch="qwen3-8b", shape="train_4k"):
    return TenantSpec(name="t", arch_id=arch, shape=shape, deadline_s=10.0,
                      H_up=4, H_low=1, penalty_per_job=1.0, max_bid=5.0)


def test_fleet_reads_the_port_records_and_refuses_a_null_term(
        tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    rec = {"status": "ok", "roofline": {"t_compute": 0.5,
                                        "t_collective": None}}
    (tmp_path / "qwen3-8b__train_4k__single.json").write_text(
        json.dumps(rec))
    fleet = FleetSimulator(64, [_tenant()], device="cpu")
    with pytest.raises(ValueError, match="item 26.*profiles="):
        fleet.tenant_class_params(fleet.tenants[0])
    rec["roofline"]["t_collective"] = 0.25
    (tmp_path / "qwen3-8b__train_4k__single.json").write_text(
        json.dumps(rec))
    p = fleet.tenant_class_params(fleet.tenants[0])
    assert (p["A"], p["B"]) == (0.5 * 256.0, 0.25 * 256.0)
    # a tenant given in profiles= reads no record
    q = fleet.tenant_class_params(_tenant("qwen3-32b"),
                                  profiles={"t": (1.0, 0.5, 1.0)})
    assert (q["A"], q["B"]) == (256.0, 128.0)
