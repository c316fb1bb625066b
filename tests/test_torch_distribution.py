"""Parity of the port's distribution (``repro_torch.models.sharding``,
``repro_torch.launch.mesh``, the spec half of ``repro_torch.launch.steps``,
``dist`` through the models, ``generate``, ``checkpoint.restore`` and
``launch.train --mesh``) with the JAX package.

JAX meshes are built with ``Auto`` axes over the conftest's host devices
(``jax.make_mesh`` builds Explicit axes on this jax, where the reference's
own sharded tests fail); the port's meshes repeat the CPU device.

* Specs: ``param_specs``, ``opt_specs``, ``batch_specs``, ``cache_specs``
  and the sanitised shardings equal JAX's leaf for leaf for every
  configuration, reduced and full, ``fsdp`` both ways, on (2, 4) and the
  production (16, 16) and (2, 16, 16) meshes.  The JAX side runs in a
  subprocess with 512 forced host devices on ``eval_shape`` trees; the
  port's trees are meta tensors of the same shapes, in the host (stacked)
  layout and in the per-layer layout, whose specs restack to JAX's.
* Models at f32, reduced, B 4 x S 16, on the port's mesh against JAX's:
  logits within ``TOL`` of the largest (``test_torch_serving.py``), the
  loss within 1e-5 relative, each parameter after a train step within
  2.01 lr of JAX's (``test_torch_steps.py``'s bounds).
* Expert parallelism: drop-free against ``moe_dense_ref``; at a capacity
  factor where the (2, .) mesh drops pairs that ``LOCAL`` keeps, against
  JAX's ``shard_map`` branch, the drop set counted per data-parallel rank;
  ``tp`` changes no bit.
* Bitwise contracts of the layout: ``LOCAL`` and a 1 x 1 mesh are the
  single-device model; a dense model's loss is the same on every mesh, and
  its gradients and decode too where no value-changing branch runs (the
  GQA repeat's backward sums the repeated heads' gradients, and the
  sequence-sharded decode rounds as its own form).
* The launcher: ``--mesh 2,2 --device cpu`` bit for bit the mesh-less run
  and within 2e-5 of JAX's step on a (2, 2) mesh; a (1, 2) run re-meshed
  onto (2, 2) through ``restore(shardings=...)`` bit for bit an
  uninterrupted run.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType
from jax.sharding import Mesh as JMesh

from _torch_lm import lm_batch, lm_pair
from test_torch_moe import activations, drop_ranks, layer_pair
from repro import checkpoint as jckpt
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import steps as jsteps
from repro.launch.mesh import dist_for as j_dist_for
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.optim import adamw as ja
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import dist_for, make_mesh, make_production_mesh
from repro_torch.models import (LOCAL, Distribution, forward, init_cache,
                                init_params, loss_fn, named_shardings,
                                param_specs)
from repro_torch.models import moe as tmoe
from repro_torch.models.sharding import NamedSharding, P, map_with_path
from repro_torch.optim import adamw as ta
from repro_torch.serving import generate
from repro_torch.utils import tree_leaves

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 1e-4
LR = 1e-3
AXES = ("data", "model")


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def jmesh(shape, axes=AXES):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), axes,
                 axis_types=(AxisType.Auto,) * len(shape))


def tdist(shape, fsdp=False):
    return dist_for(make_mesh(shape, AXES, devices=["cpu"] * int(
        np.prod(shape))), fsdp=fsdp)


def jdist(shape, fsdp=False):
    return j_dist_for(jmesh(shape), fsdp=fsdp)


# --------------------------------------------------------------------------
# specs against JAX's, every configuration, three meshes
# --------------------------------------------------------------------------

SPEC_MESHES = {"2x4": ((2, 4), AXES),
               "16x16": ((16, 16), AXES),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
BATCH_SIZES = (4, 256)
CACHE = (4, 64, 12)              # B, max_len, encoder frames
TIERS = ("f32", "int8")

SPEC_SCRIPT = r"""
import json, os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=512'
from functools import partial
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import ARCH_IDS, get_config, reduced_config
from repro.launch import steps as js
from repro.launch.mesh import dist_for
from repro.models import init_cache, init_params
from repro.models.sharding import LOCAL, param_specs
from repro.optim import OptConfig, adamw_init

MESHES, BATCH_SIZES, CACHE, TIERS = json.loads(sys.argv[1])
P = jax.sharding.PartitionSpec

def path(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

def flat(tree, leaf=lambda x: x):
    return {path(kp): leaf(x) for kp, x in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, jax.sharding.Sharding)))[0]}

def spec(s):
    s = s.spec if isinstance(s, jax.sharding.Sharding) else s
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]

def shape(x):
    return [list(x.shape), str(x.dtype)]

def batch(cfg, B, S=64):
    b = {"targets": jax.ShapeDtypeStruct((B, S), np.int32)}
    if cfg.family == "vlm":
        b["embeds"] = jax.ShapeDtypeStruct((B, S, cfg.d_model), np.float32)
        b["mrope_positions"] = jax.ShapeDtypeStruct((3, B, S), np.int32)
    else:
        b["tokens"] = jax.ShapeDtypeStruct((B, S), np.int32)
    if cfg.is_encdec:
        b["enc_embeds"] = jax.ShapeDtypeStruct((B, 12, cfg.d_model),
                                               np.float32)
    return b

out = {}
for arch in ARCH_IDS:
    for red in (True, False):
        cfg = (reduced_config if red else get_config)(arch)
        params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
        cache = jax.eval_shape(lambda: init_cache(
            cfg, CACHE[0], CACHE[1], CACHE[2] if cfg.is_encdec else 0))
        opts = {t: jax.eval_shape(partial(adamw_init, oc=OptConfig(
            state_dtype=t)), params) for t in TIERS}
        key = f"{arch}|{red}"
        out[key] = {"shapes": {"params": flat(params, shape),
                               "cache": flat(cache, shape),
                               **{f"opt_{t}": flat(o, shape)
                                  for t, o in opts.items()}},
                    "local": flat(param_specs(cfg, params, LOCAL), spec)}
        for name, (mshape, axes) in MESHES.items():
            n = int(np.prod(mshape))
            mesh = Mesh(np.array(jax.devices()[:n]).reshape(mshape),
                        tuple(axes), axis_types=(AxisType.Auto,) * len(axes))
            for fsdp in (False, True):
                dist = dist_for(mesh, fsdp=fsdp)
                ps = param_specs(cfg, params, dist)
                res = {"params": flat(ps, spec),
                       "psh": flat(js.sanitize(js.param_shardings(
                           cfg, params, dist), params, mesh), spec),
                       "cache": flat(js.cache_specs(cfg, cache, dist), spec),
                       "csh": flat(js.sanitize(js.cache_specs(
                           cfg, cache, dist), cache, mesh), spec)}
                for t, o in opts.items():
                    oc = OptConfig(state_dtype=t)
                    os_ = js.opt_specs(ps, oc, dist)
                    res[f"opt_{t}"] = flat(os_, spec)
                    osh = jax.tree_util.tree_map(
                        lambda s: js._ns(dist, s), os_,
                        is_leaf=lambda x: isinstance(x, P))
                    res[f"osh_{t}"] = flat(js.sanitize(osh, o, mesh), spec)
                for B in BATCH_SIZES:
                    b = batch(cfg, B)
                    bs = js.batch_specs(cfg, b, dist)
                    res[f"batch_{B}"] = flat(bs, spec)
                    res[f"bsh_{B}"] = flat(js.sanitize(bs, b, mesh), spec)
                out[key][f"{name}|{fsdp}"] = res
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_specs():
    """JAX's specs of every configuration on the three meshes, computed in
    a subprocess with 512 forced host devices (as
    ``tests/test_distributed.py`` runs its code)."""
    arg = json.dumps([SPEC_MESHES, BATCH_SIZES, CACHE, TIERS])
    r = subprocess.run(
        [sys.executable, "-c", SPEC_SCRIPT, arg], capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout)


def _norm(spec):
    """A spec as a tuple with tuple entries and no trailing None."""
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _flat(tree):
    out = {}
    map_with_path(lambda p, x: out.__setitem__(
        p, x.spec if isinstance(x, NamedSharding) else x), tree)
    return out


def _assert_specs(got_tree, want, label):
    got = _flat(got_tree)
    assert sorted(got) == sorted(want), label
    for path, spec in want.items():
        assert isinstance(got[path], P), (label, path)
        assert _norm(got[path]) == _norm(spec), (label, path, got[path],
                                                 spec)


def _nest(flat):
    """Nested dicts (lists where every key is an index) of a flat
    {path: leaf}."""
    root = {}
    for path, leaf in flat.items():
        keys = path.split("/")
        d = root
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = leaf

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        if all(k.isdigit() for k in t):
            return [t[str(i)] for i in range(len(t))]
        return t
    return lists(root)


def _meta(shapes):
    return _nest({p: torch.empty(s, dtype=getattr(torch, dt), device="meta")
                  for p, (s, dt) in shapes.items()})


def _restack(specs):
    """Per-layer specs of one block position (all equal) as JAX's stacked
    spec: a leading None for the layer axis."""
    specs = [s.spec if isinstance(s, NamedSharding) else s for s in specs]
    assert all(s == specs[0] for s in specs)
    return P(None, *specs[0])


def _layers_to_jax(cfg, tree):
    return convert._to_jax_layout(
        cfg, map_with_path(lambda _, s: s.spec if isinstance(
            s, NamedSharding) else s, tree), lambda s: s, _restack)


def _cache_to_jax(cfg, tree):
    """The port's per-layer cache specs in JAX's ``{"head", "blocks"}``
    layout."""
    layers = map_with_path(lambda _, s: s.spec if isinstance(
        s, NamedSharding) else s, tree)["layers"]
    first = cfg.moe.first_k_dense if cfg.moe else 0
    bl = 1 if cfg.is_encdec else cfg.block_len

    def restack(lst):
        if isinstance(lst[0], dict):
            return {k: restack([x[k] for x in lst]) for k in lst[0]}
        return _restack(lst)
    rest = layers[first:]
    return {"head": layers[:first],
            "blocks": {f"l{p}": restack(rest[p::bl]) for p in range(bl)}}


def _batch(cfg, B, S=64):
    b = {"targets": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.family == "vlm":
        b["embeds"] = torch.empty((B, S, cfg.d_model), device="meta")
        b["mrope_positions"] = torch.empty((3, B, S), dtype=torch.int32,
                                           device="meta")
    else:
        b["tokens"] = torch.empty((B, S), dtype=torch.int32, device="meta")
    if cfg.is_encdec:
        b["enc_embeds"] = torch.empty((B, CACHE[2], cfg.d_model),
                                      device="meta")
    return b


@pytest.mark.parametrize("mesh_name", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(jax_specs, arch, mesh_name):
    mshape, axes = SPEC_MESHES[mesh_name]
    n = int(np.prod(mshape))
    if mesh_name == "2x4":
        mesh = make_mesh(mshape, axes, devices=["cpu"] * n)
    else:
        mesh = make_production_mesh(multi_pod=len(mshape) == 3,
                                    devices=["cpu"] * n)
    assert tuple(mesh.shape.items()) == tuple(zip(axes, mshape))
    for red in (True, False):
        cfg = (reduced_config if red else get_config)(arch)
        ref = jax_specs[f"{arch}|{red}"]
        host = _meta(ref["shapes"]["params"])
        layers = convert.lm_params_from_host(cfg, host, device="meta")
        cache = init_cache(cfg, CACHE[0], CACHE[1],
                           CACHE[2] if cfg.is_encdec else 0, device="meta")
        for fsdp in (False, True):
            want = ref[f"{mesh_name}|{fsdp}"]
            dist = dist_for(mesh, fsdp=fsdp)
            label = f"{arch} reduced={red} {mesh_name} fsdp={fsdp}"
            # parameters: the host layout as it is, the layers restacked
            _assert_specs(param_specs(cfg, host, dist), want["params"],
                          label)
            _assert_specs(named_shardings(cfg, host, dist), want["params"],
                          label)
            _assert_specs(tsteps.sanitize(tsteps.param_shardings(
                cfg, host, dist), host, mesh), want["psh"], label)
            pspecs = param_specs(cfg, layers, dist)
            _assert_specs(_layers_to_jax(cfg, pspecs), want["params"], label)
            _assert_specs(_layers_to_jax(cfg, tsteps.sanitize(
                tsteps.param_shardings(cfg, layers, dist), layers, mesh)),
                want["psh"], label)
            # optimizer state of two tiers, per layer, restacked
            for tier in TIERS:
                oc = ta.OptConfig(state_dtype=tier)
                opt = convert.opt_state_from_host(
                    cfg, _meta(ref["shapes"][f"opt_{tier}"]), device="meta")
                ospecs = tsteps.opt_specs(pspecs, oc, dist)
                _assert_specs({"mu": _layers_to_jax(cfg, ospecs["mu"]),
                               "step": ospecs["step"]},
                              want[f"opt_{tier}"], f"{label} {tier}")
                osh = tsteps.sanitize(map_with_path(
                    lambda _, s: NamedSharding(mesh, s), ospecs), opt, mesh)
                _assert_specs({"mu": _layers_to_jax(cfg, osh["mu"]),
                               "step": osh["step"]},
                              want[f"osh_{tier}"], f"{label} {tier}")
            # batches, and the per-layer caches restacked
            for B in BATCH_SIZES:
                b = _batch(cfg, B)
                bs = tsteps.batch_specs(cfg, b, dist)
                _assert_specs(bs, want[f"batch_{B}"], f"{label} B={B}")
                _assert_specs(tsteps.sanitize(bs, b, mesh), want[f"bsh_{B}"],
                              f"{label} B={B}")
            cs = tsteps.cache_specs(cfg, cache, dist)
            _assert_specs(_cache_to_jax(cfg, cs), want["cache"], label)
            _assert_specs(_cache_to_jax(cfg, tsteps.sanitize(cs, cache,
                                                             mesh)),
                          want["csh"], label)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_specs_are_replicated(jax_specs, arch):
    cfg = reduced_config(arch)
    host = _meta(jax_specs[f"{arch}|True"]["shapes"]["params"])
    specs = param_specs(cfg, host, LOCAL)
    _assert_specs(specs, jax_specs[f"{arch}|True"]["local"], arch)
    layers = convert.lm_params_from_host(cfg, host, device="meta")
    assert all(e is None for s in _flat(param_specs(cfg, layers, LOCAL))
               .values() for e in s)


# --------------------------------------------------------------------------
# the models under a mesh against JAX's
# --------------------------------------------------------------------------

MODEL_CASES = [("qwen3-0.6b", (2, 2)), ("deepseek-moe-16b", (2, 2)),
               ("rwkv6-7b", (2, 2)), ("qwen3-0.6b", (1, 4))]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,shape", MODEL_CASES)
def test_forward_loss_and_decode_match_jax(arch, shape):
    """forward, loss_fn and generate (prefill + decode_step) under the
    port's mesh against JAX's on the same mesh shape; at (1, 4) Qwen3's two
    kv heads run the GQA repeat and the sequence-sharded decode."""
    jcfg, tcfg, jp, _, tp = lm_pair(arch)
    jb, tb = lm_batch(jcfg, 11, 4, 16, mask=True)
    jd, td = jdist(shape), tdist(shape)
    jl = jax.jit(lambda p, b: jt.forward(jcfg, p, b, jd)[0])(jp, jb)
    jloss = jax.jit(lambda p, b: jt.loss_fn(jcfg, p, b, jd)[0])(jp, jb)
    with torch.no_grad():
        tl = forward(tcfg, tp, tb, td)[0]
        tloss = loss_fn(tcfg, tp, tb, td)[0]
    assert _rel(tl, jl) <= TOL
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)

    # generate under the mesh; JAX's logits teacher-forced on its tokens
    prompt, n = np.asarray(jb["tokens"])[:, :12], 4
    toks, logits = generate(tcfg, tp, torch.tensor(prompt), max_new_tokens=n,
                            dist=td, return_logits=True)
    prefill = jax.jit(lambda p, b: jt.prefill(jcfg, p, b, jd))
    step = jax.jit(lambda p, c, t, pos: jt.decode_step(jcfg, p, c, t, pos,
                                                       jd))
    from repro.serving import pad_attn_cache as j_pad
    lg, cache = prefill(jp, {"tokens": jnp.asarray(prompt)})
    cache = j_pad(cache, n)
    want = [np.asarray(lg[:, -1])]
    for i in range(n - 1):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, i].numpy()),
                         jnp.int32(12 + i))
        want.append(np.asarray(lg[:, -1]))
    assert _rel(logits, np.stack(want, axis=1)) <= TOL


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch,shape", MODEL_CASES)
def test_train_step_matches_jax(arch, shape, accum):
    jcfg, tcfg, jp, _, tp = lm_pair(arch, grad_accum=accum)
    jb, tb = lm_batch(jcfg, 11, 4, 16, mask=True)
    oc = ja.OptConfig(lr=LR, schedule="const", warmup_steps=1)
    toc = ta.OptConfig(**oc.__dict__)
    jp2, _, jm = jax.jit(jsteps.make_train_step(jcfg, jdist(shape), oc))(
        jp, ja.adamw_init(jp, oc), jb)
    tp2, _, tm = tsteps.make_train_step(tcfg, tdist(shape), toc)(
        tp, ta.adamw_init(tp, toc), tb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    new = convert.lm_params_to_numpy(tcfg, tp2)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jp2),
                            jax.tree_util.tree_leaves(new)):
        assert float(np.abs(g - np.asarray(w)).max()) <= 2.01 * LR, path


# --------------------------------------------------------------------------
# expert parallelism
# --------------------------------------------------------------------------

def test_expert_parallel_matches_dense_oracle():
    """The port's counterpart of ``tests/test_distributed.py::
    test_moe_shard_map_matches_dense_oracle``: the same configuration on a
    (2, 4) mesh against ``moe_dense_ref`` at 3e-5."""
    _, tcfg, _, tp = layer_pair("deepseek-moe-16b", n_experts=8, top_k=2,
                                d_ff_expert=64, n_shared=1,
                                capacity_factor=16.0)
    _, tx = activations(1, 4, 16, tcfg.d_model)
    g, i, _ = tmoe.route(tcfg, tp, tx)
    got = tmoe.moe_apply(tcfg, tp, tx, g, i, tdist((2, 4)))
    want = tmoe.moe_dense_ref(tcfg, tp, tx, g, i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5,
                               atol=3e-5)


def _skewed(seed, B, S, d):
    """Activations that share one component, so the experts' loads are
    uneven and a capacity factor of 1 drops pairs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, d)) + 2.0 * rng.standard_normal(d))
    return x.astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_expert_parallel_drops_as_jax(shape):
    """Capacity factor 1.0 on a (2, .) mesh: each data-parallel rank's 32
    tokens get the capacity of 32, and the pairs that overflow a rank's
    queue are dropped there, pairs that ``LOCAL``'s one queue of 64 tokens
    keeps.  The port drops exactly those (its output is the oracle with
    their gates zeroed) and equals JAX's ``shard_map`` branch within 1e-6
    of the largest output."""
    jcfg, tcfg, jp, tp = layer_pair("deepseek-moe-16b", capacity_factor=1.0)
    x = _skewed(3, 4, 16, jcfg.d_model)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jg, ji, _ = jmoe.route(jcfg, jp, jx)
    g, i = torch.tensor(np.asarray(jg)), torch.tensor(np.asarray(ji))
    dp, T = shape[0], 64
    cap_rank, cap_local = tmoe.capacity(tcfg, T // dp), tmoe.capacity(tcfg, T)
    idx = np.asarray(ji).reshape(T, -1)
    per_rank = np.concatenate([drop_ranks(part, cap_rank)[1]
                               for part in np.split(idx, dp)])
    local = drop_ranks(idx, cap_local)[1]
    assert (per_rank & ~local).any(), "the mesh is meant to drop more"
    got = tmoe.moe_apply(tcfg, tp, tx, g, i, tdist(shape))
    kept = g * torch.tensor(~per_rank.reshape(g.shape))
    np.testing.assert_allclose(
        got.numpy(), tmoe.moe_dense_ref(tcfg, tp, tx, kept, i).numpy(),
        rtol=0, atol=3e-5 * float(got.abs().max()))
    jd = jdist(shape)
    want = jax.jit(lambda p, x, g, i: jmoe.moe_apply(jcfg, p, x, g, i, jd))(
        jp, jx, jg, ji)
    assert _rel(got, want) <= 1e-6
    assert not torch.allclose(got, tmoe.moe_apply(tcfg, tp, tx, g, i))


def test_tensor_parallel_changes_no_bit():
    """tp = 1, 2 and 4 on two data-parallel ranks at a dropping capacity
    factor: outputs and gradients bit for bit; (1, 1) bit for bit
    ``LOCAL``."""
    _, tcfg, _, tp = layer_pair("deepseek-moe-16b", capacity_factor=1.0)
    x = torch.tensor(_skewed(4, 4, 16, tcfg.d_model))
    g, i, _ = tmoe.route(tcfg, tp, x)

    def run(dist):
        xs = x.clone().requires_grad_(True)
        ex = {k: v.clone().requires_grad_(True)
              for k, v in tp["experts"].items()}
        out = tmoe.moe_apply(tcfg, {**tp, "experts": ex}, xs, g, i, dist)
        out.square().sum().backward()
        return [out.detach(), xs.grad] + [ex[k].grad for k in sorted(ex)]

    base = run(tdist((2, 1)))
    for dist in (tdist((2, 2)), tdist((2, 4))):
        assert all(torch.equal(a, b) for a, b in zip(run(dist), base))
    assert all(torch.equal(a, b) for a, b in zip(run(tdist((1, 1))),
                                                 run(LOCAL)))


# --------------------------------------------------------------------------
# bitwise contracts of the layout
# --------------------------------------------------------------------------

def _model_outputs(cfg, params, tb, dist):
    """forward logits, loss and gradients, and a generate's tokens and
    logits, under ``dist`` (None: the functions' defaults)."""
    kw = {} if dist is None else {"dist": dist}
    step = tsteps.make_grad_step(cfg, LOCAL if dist is None else dist)
    grads, loss, _ = step(params, tb)
    with torch.no_grad():
        logits = (forward(cfg, params, tb) if dist is None
                  else forward(cfg, params, tb, dist))[0]
    extra = ({"enc_embeds": tb["enc_embeds"]} if cfg.is_encdec else {})
    toks, glog = generate(cfg, params, tb["targets"][:, :8],
                          max_new_tokens=3, return_logits=True, **kw,
                          **extra)
    return {"logits": [logits], "loss": [loss], "grads": tree_leaves(grads),
            "generate": [toks, glog]}


def _same(a, b, keys):
    return {k: all(torch.equal(x, y) for x, y in zip(a[k], b[k]))
            for k in keys}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_and_a_one_by_one_mesh_are_the_single_device_model(
        arch, deterministic):
    cfg = reduced_config(arch)
    params = init_params(cfg, 3, device="cpu")
    _, tb = lm_batch(cfg, 5, 2, 16, mask=True)
    base = _model_outputs(cfg, params, tb, None)
    keys = list(base)
    for dist in (LOCAL, tdist((1, 1)), tdist((1, 1), fsdp=True)):
        assert all(_same(_model_outputs(cfg, params, tb, dist), base,
                         keys).values()), dist


@pytest.mark.parametrize("arch,shape,branch", [
    ("qwen3-0.6b", (2, 2), False), ("qwen3-0.6b", (1, 2), False),
    ("qwen3-0.6b", (2, 4), True), ("qwen3-0.6b", (1, 4), True),
    ("rwkv6-7b", (2, 2), False), ("rwkv6-7b", (1, 4), False),
    ("minicpm-2b", (2, 4), False)])
def test_dense_models_are_the_same_on_every_mesh(arch, shape, branch,
                                                 deterministic):
    """The forward and the loss are bit for bit ``LOCAL``'s on every mesh
    (the GQA repeat included: each query head meets the same keys); the
    gradients and the decode too where no value-changing branch runs.
    Where the repeat and the sequence-sharded decode run (Qwen3's two kv
    heads below tp), those differ from ``LOCAL`` in rounding only."""
    cfg = reduced_config(arch)
    params = init_params(cfg, 3, device="cpu")
    _, tb = lm_batch(cfg, 5, 4, 16, mask=True)
    base = _model_outputs(cfg, params, tb, LOCAL)
    got = _model_outputs(cfg, params, tb, tdist(shape))
    same = _same(got, base, list(base))
    assert same["logits"] and same["loss"]
    assert same["grads"] and same["generate"] or branch
    if branch:
        assert not (same["grads"] and same["generate"])
        for a, b in zip(got["grads"] + got["generate"][1:],
                        base["grads"] + base["generate"][1:]):
            scale = float(b.abs().max()) or 1.0
            assert float((a - b).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("shape,heads,seq_sharded", [
    (None, 2, False), ((1, 1), 2, False), ((2, 2), 2, False),
    ((1, 4), 4, True), ((2, 4), 4, True)])
def test_value_changing_branches_follow_the_reference_rules(
        monkeypatch, shape, heads, seq_sharded):
    """Reduced Qwen3 (4 query, 2 kv heads): a prefill attends over
    ``tp`` kv heads where tp exceeds 2 (the GQA repeat), and a decode step
    takes the sequence-sharded form where 2 kv heads do not divide tp (JAX
    ``transformer.py:162-183``)."""
    from repro_torch.models import attention, decode_step, prefill
    from repro_torch.serving import pad_attn_cache
    cfg = reduced_config("qwen3-0.6b")
    params = init_params(cfg, 0, device="cpu")
    dist = LOCAL if shape is None else tdist(shape)
    seen = {"heads": [], "seq_sharded": []}
    attend, decode = attention.attention, attention.decode_attention

    def spy_attend(q, k, v, **kw):
        seen["heads"].append(k.shape[2])
        return attend(q, k, v, **kw)

    def spy_decode(q, k, v, kv_len, dist=None, seq_sharded=False):
        seen["seq_sharded"].append(seq_sharded)
        return decode(q, k, v, kv_len, dist, seq_sharded)
    monkeypatch.setattr(attention, "attention", spy_attend)
    monkeypatch.setattr(attention, "decode_attention", spy_decode)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                          (2, 8)))
    with torch.no_grad():
        _, cache = prefill(cfg, params, {"tokens": toks}, dist)
        assert cache["layers"][0]["attn"]["k"].shape[2] == cfg.n_kv
        decode_step(cfg, params, pad_attn_cache(cache, 1), toks[:, -1], 8,
                    dist)
    assert seen == {"heads": [heads] * cfg.n_layers,
                    "seq_sharded": [seq_sharded] * cfg.n_layers}


def test_constrain_checks_the_spec_and_returns_the_tensor():
    x = torch.zeros(2, 3, 4)
    assert LOCAL.constrain(x, "nope", "nope", None, None, None) is x
    d = tdist((2, 2))
    assert d.constrain(x, ("data",), None, "model") is x
    assert d.constrain(x, None) is x
    with pytest.raises(ValueError, match="rank 3"):
        d.constrain(x, "data", None, None, "model")
    with pytest.raises(ValueError, match="not on the mesh"):
        d.constrain(x, "pod", None, None)
    with pytest.raises(ValueError, match="used twice"):
        d.constrain(x, ("data", "model"), "model", None)
    with pytest.raises(ValueError, match="not on the mesh"):
        NamedSharding(d.mesh, P("pod"))
    assert tuple(P(("data",), None)) == ("data", None)
    assert tuple(P((), ("data", "model"))) == (None, ("data", "model"))
    assert d.tp_size() == 2 and LOCAL.tp_size() == 1
    assert d.fsdp_axis is None and tdist((2, 2), fsdp=True).fsdp_axis == \
        "data"
    assert LOCAL.dp is None and LOCAL.tp is None and d.dp == ("data",)


def test_meshes_need_their_cards(monkeypatch):
    """No fallback: without CUDA, or with fewer cards than positions, the
    mesh builders and ``--mesh`` on the card raise; a device repeats only
    where the caller lists it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: make_mesh((1, 1), AXES),
                  lambda: make_production_mesh(),
                  lambda: ttrain.main(["--reduced", "--mesh", "1,1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for build in (lambda: make_mesh((1, 16), AXES),
                  lambda: make_production_mesh(multi_pod=True),
                  lambda: ttrain.main(["--reduced", "--mesh", "2,2"])):
        with pytest.raises(ValueError, match="devices="):
            build()
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), AXES, devices=["cpu"] * 3)
    mesh = make_mesh((1, 16), AXES, devices=["cpu"] * 16)
    assert mesh.devices.shape == (1, 16)
    assert dict(mesh.shape) == {"data": 1, "model": 16}
    assert dist_for(make_production_mesh(multi_pod=True, devices=["cpu"] *
                                         512), fsdp=True) == Distribution(
        mesh=make_production_mesh(multi_pod=True, devices=["cpu"] * 512),
        dp_axes=("pod", "data"), tp_axis="model", fsdp=True)


# --------------------------------------------------------------------------
# restore onto a mesh, the launcher and the re-mesh resume
# --------------------------------------------------------------------------

def test_restore_places_leaves_on_their_sharding(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    tckpt.save(tree, 1, str(tmp_path))
    like = {"a": torch.empty(2, 3, device="meta"),
            "b": [torch.empty(2, device="meta")]}
    mesh = make_mesh((2, 1), AXES, devices=["cpu"] * 2)
    out, _ = tckpt.restore(like, 1, str(tmp_path),
                           shardings={"a": NamedSharding(mesh, P("data")),
                                      "b": None})
    assert out["a"].device.type == "cpu" and torch.equal(out["a"], tree["a"])
    assert out["b"][0].device.type == "meta"


ARGS = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "4",
        "--global-batch", "4", "--seq", "32", "--grad-accum", "2",
        "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]


def test_launcher_mesh_against_jax(tmp_path, deterministic):
    """Both launchers' first state is JAX's, saved as step 0: the port's
    ``--mesh 2,2`` losses are the mesh-less run's bit for bit and within
    2e-5 of JAX's ``make_train_step`` jitted on an Auto (2, 2) mesh."""
    jcfg = lm_pair("qwen3-0.6b", grad_accum=2)[0]
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    oc = ja.OptConfig(lr=3e-4, schedule="cosine", total_steps=4,
                      warmup_steps=4)
    jopt = ja.adamw_init(jp, oc)
    jckpt.save({"params": jp, "opt": jopt}, 0, str(tmp_path / "mesh"))
    shutil.copytree(tmp_path / "mesh", tmp_path / "local")
    mesh = ttrain.main(ARGS + ["--mesh", "2,2", "--ckpt-dir",
                               str(tmp_path / "mesh")])
    local = ttrain.main(ARGS + ["--ckpt-dir", str(tmp_path / "local")])
    assert mesh == local

    step = jax.jit(jsteps.make_train_step(jcfg, jdist((2, 2)), oc))
    data = JSyntheticLM(jcfg.vocab, 32, 4, seed=0)
    want = []
    for s in range(4):
        jp, jopt, m = step(jp, jopt, jax.tree_util.tree_map(jnp.asarray,
                                                            data(s)))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(mesh, want, rtol=2e-5)


def test_remesh_resume_is_bit_for_bit(tmp_path, deterministic):
    """The elastic re-mesh of ``tests/test_distributed.py``: 3 steps on a
    (1, 2) mesh, a checkpoint, ``restore(shardings=...)`` onto (2, 2), 3
    more steps: the uninterrupted (1, 2) run's losses and parameters bit
    for bit (the reference allows 2e-2 after its re-mesh)."""
    cfg = reduced_config("qwen3-0.6b")
    oc = ta.OptConfig(lr=1e-3, total_steps=20, warmup_steps=1)
    data = SyntheticLM(cfg.vocab, 32, 4, seed=0)

    def run(dist, start, stop, params, opt):
        step = tsteps.make_train_step(cfg, dist, oc)
        losses = []
        for s in range(start, stop):
            batch = {k: torch.from_numpy(v) for k, v in data(s).items()}
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))
        return params, opt, losses

    params = init_params(cfg, 0, device="cpu")
    opt = ta.adamw_init(params, oc)
    p_ref, o_ref, l_ref = run(tdist((1, 2)), 0, 6, params, opt)
    p1, o1, l1 = run(tdist((1, 2)), 0, 3, params, opt)
    tckpt.save(ttrain.host_state(cfg, p1, o1), 3, str(tmp_path))
    d22 = tdist((2, 2))
    like = ttrain.host_state(cfg, params, opt)
    state, _ = tckpt.restore(like, 3, str(tmp_path), shardings={
        "params": tsteps.param_shardings(cfg, like["params"], d22),
        "opt": None})
    p2, o2, l2 = run(d22, 3, 6,
                     convert.lm_params_from_host(cfg, state["params"],
                                                 device="cpu"),
                     convert.opt_state_from_host(cfg, state["opt"],
                                                 device="cpu"))
    assert l1 + l2 == l_ref
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves((p2, o2)), tree_leaves((p_ref, o_ref))))


# --------------------------------------------------------------------------
# the dry run's jit_* steps
# --------------------------------------------------------------------------

def _same_leaves(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


def test_jit_steps_are_the_make_steps_and_match_jax():
    """``jit_grad_step_micro``, ``jit_opt_step``, ``jit_prefill_step`` and
    ``jit_decode_step`` on a (2, 2) CPU mesh: bit for bit the ``make_*``
    steps, and against JAX's on a (2, 2) mesh within this file's bounds
    (the gradients within ``test_torch_loss.py``'s 1e-4 of each leaf's
    largest).  Qwen2-VL's ``mrope_positions`` split their batch on axis 1;
    a decode batch of 3 does not divide the data axis (replicated token)."""
    from _torch_lm import GRAD_RTOL, assert_tree_close
    from repro.models import init_cache as j_init_cache
    arch, M = "qwen2-vl-7b", 2
    jcfg, tcfg, jp, _, tp = lm_pair(arch)
    jb, tb = lm_batch(jcfg, 11, 4, 16)
    jd, td = jdist((2, 2)), tdist((2, 2))

    step, (p_arg, mb) = tsteps.jit_grad_step_micro(tcfg, td, tp, tb, M)
    real = {k: v[:, :2] if k == "mrope_positions" else v[:2]
            for k, v in tb.items()}
    assert p_arg is tp and all(t.is_meta for t in tree_leaves(mb))
    assert {k: v.shape for k, v in mb.items()} == {
        k: v.shape for k, v in real.items()}
    g, loss, _ = step(tp, real)
    g_make, loss_make, _ = tsteps.make_grad_step(tcfg, td)(tp, real)
    assert _same_leaves((g, loss), (g_make, loss_make))
    jreal = {k: v[:, :2] if k == "mrope_positions" else v[:2]
             for k, v in jb.items()}
    jg, jloss, _ = jax.jit(jsteps.make_grad_step(jcfg, jd))(jp, jreal)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert_tree_close(convert.lm_params_to_numpy(tcfg, g), jg, GRAD_RTOL)

    oc = ja.OptConfig(lr=LR, schedule="const", warmup_steps=1)
    toc = ta.OptConfig(**oc.__dict__)
    g32 = convert.lm_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jg), device="cpu")
    step, (_, _, g_meta) = tsteps.jit_opt_step(tcfg, td, toc, tp,
                                               ta.adamw_init(tp, toc))
    assert [(t.shape, t.dtype, t.is_meta) for t in tree_leaves(g_meta)] == [
        (t.shape, torch.float32, True) for t in tree_leaves(tp)]
    new = step(tp, ta.adamw_init(tp, toc), g32)
    assert _same_leaves(new, tsteps.make_opt_step(tcfg, toc)(
        tp, ta.adamw_init(tp, toc), g32))
    jnew = jax.jit(jsteps.make_opt_step(jcfg, oc))(jp, ja.adamw_init(jp, oc),
                                                   jg)
    for w, x in zip(jax.tree_util.tree_leaves(jnew[0]), jax.tree_util.
                    tree_leaves(convert.lm_params_to_numpy(tcfg, new[0]))):
        assert float(np.abs(x - np.asarray(w)).max()) <= 2.01 * LR

    pre = tsteps.jit_prefill_step(tcfg, td, tp, tb)(tp, tb)
    assert _same_leaves(pre, tsteps.make_prefill_step(tcfg, td)(tp, tb))
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, jd))(jp, jb)
    assert _rel(pre[0], jpre[0]) <= TOL

    for B in (4, 3):
        cache = init_cache(tcfg, B, 8, device="cpu")
        tok = torch.tensor(np.asarray(jb["targets"])[:B, 0])
        step = tsteps.jit_decode_step(tcfg, td, tp, cache)
        got = step(tp, cache, tok, torch.tensor(0, dtype=torch.int32))
        want = tsteps.make_decode_step(tcfg, td)(
            tp, init_cache(tcfg, B, 8, device="cpu"), tok, 0)
        assert _same_leaves(got, want)
    jlog, _ = jax.jit(jsteps.make_decode_step(jcfg, jd))(
        jp, j_init_cache(jcfg, 3, 8), jnp.asarray(tok.numpy()), jnp.int32(0))
    assert _rel(got[0], jlog) <= TOL
