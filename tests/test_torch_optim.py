"""Parity of the port's AdamW (``repro_torch.optim``) with JAX's
``repro.optim.adamw``, and AdamW state crossing between the packages
(``convert.opt_state_{from,to}_numpy``).

Inputs are numpy-seeded f32 parameters and gradients handed to both.  The
int8 block quantization is bitwise: both divide by the block's absmax /
127 and round half to even.  The schedules and the AdamW steps are the
same f32 formulas; XLA may contract a product and a sum into one rounding
(an FMA) where torch rounds twice, and ``pow`` / ``cos`` / ``sqrt`` may
differ in their last bit, so values are held within a few f32 ULPs: the
schedules within 2 ULPs of the peak rate ``lr`` (the cosine's ``1 +
cos`` cancels, so one ULP of the cosine is 3 ULPs of the rate at 80 % of
the run), parameters, ``m``, ``v`` and ``master``
within 4 of the leaf's largest |value| (measured: at most 2 elementwise).
The bf16 tier's moments are held within one bf16 ULP of the leaf's
largest value (an f32 ULP apart can round to neighbouring bf16 values);
int8 ``q`` within 1 (a scaled value at a rounding tie; measured: never)
and its scales within 4 f32 ULPs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal, assert_ulp_close
from _torch_lm import lm_pair
from repro.optim import adamw as ja
from repro_torch import convert
from repro_torch.optim import adamw as ta

TIERS = ("f32", "bf16", "int8")


def oc_pair(**kw):
    oc = ja.OptConfig(**kw)
    return oc, ta.OptConfig(**oc.__dict__)


# --------------------------------------------------------------------------
# int8 blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 300), (2, 512), (513,), (4, 7),
                                   (2, 3, 260)])
def test_q8_and_dq8_bitwise(shape):
    """A padded last axis (300, 513, 7, 260), an exact one (512), and an
    all-zero block (row 1's second block; the scale floor 1e-12)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, shape)
         ).astype(np.float32)
    x.reshape(-1, shape[-1])[min(1, x.size // shape[-1] - 1), 256:] = 0.0
    jq = ja._q8(jnp.asarray(x))
    tq = ta._q8(torch.tensor(x))
    assert_bitwise_equal(tq["q"].numpy(), np.asarray(jq["q"]), "q")
    assert_bitwise_equal(tq["scale"].numpy(), np.asarray(jq["scale"]),
                         "scale")
    assert_bitwise_equal(ta._dq8(tq, shape).numpy(),
                         np.asarray(ja._dq8(jq, shape)), "dq8")


def test_q8_of_zeros_has_the_floor_scale():
    tq = ta._q8(torch.zeros((2, 300)))
    assert tq["q"].shape == (2, 512) and tq["q"].dtype == torch.int8
    assert not tq["q"].any()
    assert torch.equal(tq["scale"], torch.full((2, 2), 1e-12))


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["const", "cosine", "wsd"])
def test_schedules_match_jax(kind):
    """Steps 0, 1, mid warm-up, the end of warm-up, mid run, the start of
    WSD's decay, the end and past it, as Python ints and as int32
    tensors."""
    oc, toc = oc_pair(lr=3e-4, schedule=kind, warmup_steps=100,
                      total_steps=1000, decay_frac=0.2)
    js, ts = ja.make_schedule(oc), ta.make_schedule(toc)
    for step in (0, 1, 50, 100, 550, 800, 900, 1000, 1200):
        want = np.asarray(js(step), np.float32)
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = ts(arg)
            assert got.dtype == torch.float32
            assert_ulp_close(got.numpy(), want, ulps=2, scale=oc.lr,
                             err_msg=f"{kind} step {step}")
    assert float(ts(0)) == 0.0


# --------------------------------------------------------------------------
# AdamW steps
# --------------------------------------------------------------------------

def _params(rng):
    """A small tree of dicts and a list, last axes ragged against 256 and
    one leaf of zeros."""
    return {"w": rng.standard_normal((3, 300)).astype(np.float32),
            "blocks": [{"a": rng.standard_normal((513,)).astype(np.float32),
                        "b": rng.standard_normal((4, 256)).astype(np.float32)}
                       for _ in range(2)],
            "z": np.zeros((2, 7), np.float32)}


def _grads(rng, like):
    return jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.5).astype(np.float32),
        like)


def _close_state(tier, got, want, label):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[getattr(p, "key", getattr(p, "idx", None))]
        name = f"{label}{jax.tree_util.keystr(path)}"
        w = np.asarray(w)
        g = g.numpy() if g.dtype != torch.bfloat16 else g.float().numpy()
        if name.endswith("['q']"):
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
        elif tier == "bf16" and "master" not in name:
            w = w.astype(np.float32)
            np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -8 * max(
                float(np.abs(w).max()), 1e-30), err_msg=name)
        else:
            assert_ulp_close(g, w, ulps=4, err_msg=name)


@pytest.mark.parametrize("tier", TIERS)
def test_adamw_steps_match_jax(tier):
    """Three steps from numpy gradients, checked after the first and the
    third: parameters, state, lr and the global norm."""
    rng = np.random.default_rng(7)
    P = _params(rng)
    oc, toc = oc_pair(lr=1e-2, state_dtype=tier, schedule="cosine",
                      warmup_steps=2, total_steps=10)
    jp = jax.tree_util.tree_map(jnp.asarray, P)
    tp = jax.tree_util.tree_map(torch.tensor, P)
    js, ts = ja.adamw_init(jp, oc), ta.adamw_init(tp, toc)
    for i in range(3):
        G = _grads(rng, P)
        jp, js, jm = ja.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, G), js, oc)
        tp, ts, tm = ta.adamw_update(
            tp, jax.tree_util.tree_map(torch.tensor, G), ts, toc)
        if i in (0, 2):
            assert int(ts["step"]) == int(js["step"]) == i + 1
            assert_ulp_close(tm["lr"].numpy(), np.asarray(jm["lr"]), ulps=2,
                             scale=oc.lr)
            assert_ulp_close(tm["grad_norm"].numpy(),
                             np.asarray(jm["grad_norm"]), ulps=4)
            for path, w in jax.tree_util.tree_leaves_with_path(jp):
                g = tp
                for p in path:
                    g = g[getattr(p, "key", getattr(p, "idx", None))]
                assert_ulp_close(g.numpy(), np.asarray(w), ulps=4,
                                 err_msg=f"step {i}{path}")
            _close_state(tier, ts["mu"], js["mu"], f"{tier} step {i} ")


@pytest.mark.parametrize("tier", TIERS)
def test_adamw_is_functional(tier):
    """``adamw_update`` returns new trees: the parameters, gradients and
    state passed in are unchanged, the f32 master shares no memory with f32
    parameters, and parameters that require grad come back detached."""
    rng = np.random.default_rng(8)
    oc = ta.OptConfig(state_dtype=tier, schedule="const", warmup_steps=1)
    params = jax.tree_util.tree_map(
        lambda x: torch.tensor(x).requires_grad_(True), _params(rng))
    grads = jax.tree_util.tree_map(torch.tensor, _grads(rng, _params(rng)))
    state = ta.adamw_init(params, oc)
    if tier == "f32":
        assert (state["mu"]["w"]["master"].data_ptr()
                != params["w"].data_ptr())
    before = [t.clone() for t in jax.tree_util.tree_leaves((params, grads,
                                                              state))]
    new_params, new_state, _ = ta.adamw_update(params, grads, state, oc)
    after = jax.tree_util.tree_leaves((params, grads, state))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not any(t.requires_grad for t in
                   jax.tree_util.tree_leaves((new_params, new_state)))
    assert int(new_state["step"]) == 1 and int(state["step"]) == 0
    assert not torch.equal(new_params["w"], params["w"])


def test_adamw_keeps_bf16_parameters_bf16():
    """bf16 parameters update in f32 and come back bf16; the f32 tier's
    master stays f32."""
    p = {"w": torch.ones((2, 300), dtype=torch.bfloat16)}
    g = {"w": torch.full((2, 300), 0.5)}
    for tier in TIERS:
        oc = ta.OptConfig(state_dtype=tier, schedule="const", warmup_steps=1)
        new, state, _ = ta.adamw_update(p, g, ta.adamw_init(p, oc), oc)
        assert new["w"].dtype == torch.bfloat16
        if tier == "f32":
            assert state["mu"]["w"]["master"].dtype == torch.float32


# --------------------------------------------------------------------------
# state crossing between the packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-v0.1-52b",
                                  "whisper-base"])
@pytest.mark.parametrize("tier", TIERS)
def test_opt_state_round_trips(arch, tier):
    """JAX's state after one update → the port's → JAX's layout, bit for
    bit, every dtype kept; the port's state has the port parameters'
    structure, so an update can take it."""
    _, tcfg, jp, _, tp = lm_pair(arch)
    oc, toc = oc_pair(state_dtype=tier)
    g = jax.tree_util.tree_map(lambda x: jnp.full(x.shape, 0.25, x.dtype),
                               jp)
    _, jstate, _ = ja.adamw_update(jp, g, ja.adamw_init(jp, oc), oc)
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    state = convert.opt_state_from_numpy(tcfg, tree, device="cpu")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    back = convert.opt_state_to_numpy(tcfg, state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, w), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree_util.tree_leaves(back)):
        assert_bitwise_equal(b, w, jax.tree_util.keystr(path))
    grads = jax.tree_util.tree_map(torch.zeros_like, tp)
    ta.adamw_update(tp, grads, state, toc)
