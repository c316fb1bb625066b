"""Parity of the port's Mixture-of-Experts layer (``repro_torch.models.moe``)
with the JAX package's, on the same weights and activations.

JAX draws the layer's weights (``moe_init`` on a fixed key) at the reduced
DeepSeekMoE and Kimi-K2 configurations; they cross to the port as numpy
arrays, and both packages see the same numpy-seeded activations.  Routing
is held exactly in its indices and within f32 rounding in its gates and
load-balance loss.  The expert dispatch is fed the SAME gates and indices
on both sides (JAX's), so that a near tie in routing cannot flip the
comparison, both drop-free (capacity factor 16) and with drops (1.0).  In
f32 the two compute the same products and differ in the order of their
sums (the port combines a token's k outputs in f32 in j order, JAX
scatter-adds them), so outputs are held within 1e-5 of the largest one; in
bf16 both round each output once more, within 2^-7 of the largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_close
from repro.configs import reduced_config as j_reduced
from repro.models import moe as jmoe
from repro.models.sharding import LOCAL
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import moe as tmoe

KEY = jax.random.PRNGKey(0)
ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
F32_REL = 1e-5
BF16_REL = 2.0 ** -7


def with_moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def layer_pair(arch, dtype="float32", **moe_kw):
    jcfg = with_moe(j_reduced(arch), **moe_kw).replace(dtype=dtype,
                                                       param_dtype=dtype)
    tcfg = with_moe(t_reduced(arch), **moe_kw).replace(dtype=dtype,
                                                       param_dtype=dtype)
    jp = jmoe.moe_init(jcfg, KEY)
    tp = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32)).to(tcfg.pdtype)
        if a.dtype != np.float32 else torch.tensor(np.asarray(a)), jp)
    return jcfg, tcfg, jp, tp


def activations(seed, B, S, d, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal((B, S, d))
    x = x.astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jx, torch.tensor(x).to(getattr(torch, dtype))


def drop_ranks(idx, cap):
    """Each (token, j) pair's place in its expert's queue, counted in
    token-major order with a cumulative sum (no sort), and whether it is
    dropped (place >= cap)."""
    flat = np.asarray(idx).reshape(-1)
    one_hot = np.eye(int(flat.max()) + 1, dtype=np.int64)[flat]
    rank = np.cumsum(one_hot, axis=0)[np.arange(flat.size), flat] - 1
    return rank.reshape(np.asarray(idx).shape), (rank >= cap).reshape(
        np.asarray(idx).shape)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("renorm", [True, False])
def test_route_matches_jax(arch, renorm):
    jcfg, tcfg, jp, tp = layer_pair(arch, renorm_top_k=renorm)
    jx, tx = activations(1, 2, 24, jcfg.d_model)
    jg, ji, ja = jmoe.route(jcfg, jp, jx)
    tg, ti, ta = tmoe.route(tcfg, tp, tx)
    assert tg.dtype == torch.float32 and ta.dtype == torch.float32
    assert tuple(ti.shape) == (2, 24, jcfg.moe.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    assert float(ta) == pytest.approx(float(ja), rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf,dtype", [(16.0, "float32"), (1.0, "float32"),
                                      (16.0, "bfloat16"), (1.0, "bfloat16")])
def test_moe_apply_matches_jax_on_the_same_routing(arch, cf, dtype):
    jcfg, tcfg, jp, tp = layer_pair(arch, dtype, capacity_factor=cf)
    jx, tx = activations(2, 2, 24, jcfg.d_model, dtype)
    jg, ji, _ = jmoe.route(jcfg, jp, jx)
    T, k = 48, jcfg.moe.top_k
    cap = tmoe.capacity(tcfg, T)
    _, dropped = drop_ranks(ji, cap)
    if cf >= jcfg.moe.n_experts / k:
        assert cap >= T and not dropped.any()
    else:
        assert dropped.any(), "the case is meant to drop pairs"
    want = jmoe.moe_apply(jcfg, jp, jx, jg, ji, LOCAL)
    got = tmoe.moe_apply(tcfg, tp, tx, torch.tensor(np.asarray(jg)),
                         torch.tensor(np.asarray(ji)))
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(tx.shape)
    rel = F32_REL if dtype == "float32" else BF16_REL
    assert_rel_close(got, np.asarray(want, np.float32), rel,
                     f"{arch} cf={cf} {dtype}")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_ref_matches_jax(arch):
    jcfg, tcfg, jp, tp = layer_pair(arch)
    jx, tx = activations(3, 2, 24, jcfg.d_model)
    jg, ji, _ = jmoe.route(jcfg, jp, jx)
    want = jmoe.moe_dense_ref(jcfg, jp, jx, jg, ji)
    got = tmoe.moe_dense_ref(tcfg, tp, tx, torch.tensor(np.asarray(jg)),
                             torch.tensor(np.asarray(ji)))
    assert_rel_close(got, np.asarray(want), F32_REL, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_equals_dense_ref_when_nothing_drops(arch):
    jcfg, tcfg, _, tp = layer_pair(arch, capacity_factor=16.0)
    _, tx = activations(4, 3, 20, tcfg.d_model)
    g, i, _ = tmoe.route(tcfg, tp, tx)
    assert_rel_close(tmoe.moe_apply(tcfg, tp, tx, g, i),
                     tmoe.moe_dense_ref(tcfg, tp, tx, g, i), F32_REL, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_pairs_are_the_queue_overflow(arch):
    """With drops, ``moe_apply`` equals ``moe_dense_ref`` with the gates of
    the dropped pairs zeroed, the drop set counted independently (the
    card's check of the full-width layer, at a small size)."""
    _, tcfg, _, tp = layer_pair(arch, capacity_factor=0.5)
    _, tx = activations(5, 2, 40, tcfg.d_model)
    g, i, _ = tmoe.route(tcfg, tp, tx)
    _, dropped = drop_ranks(i.numpy(), tmoe.capacity(tcfg, 80))
    assert dropped.any() and not dropped.all()
    kept_g = g * torch.tensor(~dropped)
    assert_rel_close(tmoe.moe_apply(tcfg, tp, tx, g, i),
                     tmoe.moe_dense_ref(tcfg, tp, tx, kept_g, i), F32_REL,
                     arch)


@pytest.mark.parametrize("T", [1, 4, 48, 1000, 4096])
@pytest.mark.parametrize("cf", [1.0, 1.25, 64 / 6])
def test_capacity_is_the_reference_formula(T, cf):
    tcfg = with_moe(t_reduced("deepseek-moe-16b"), n_experts=64, top_k=6,
                    capacity_factor=cf)
    cap = int(-(-T * 6 * cf // 64))
    assert tmoe.capacity(tcfg, T) == max(8, -(-cap // 8) * 8)
    if cf >= 64 / 6:
        assert tmoe.capacity(tcfg, T) >= T


def test_moe_apply_is_deterministic():
    _, tcfg, _, tp = layer_pair("deepseek-moe-16b", capacity_factor=1.0)
    _, tx = activations(6, 2, 32, tcfg.d_model)
    g, i, _ = tmoe.route(tcfg, tp, tx)
    a = tmoe.moe_apply(tcfg, tp, tx, g, i)
    b = tmoe.moe_apply(tcfg, tp, tx, g, i)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bmm_is_the_experts_einsum(dtype):
    """``layers.bmm`` computes the reference's expert product
    (``einsum("ecd,edf->ecf", preferred_element_type=float32)``) with an
    f32 result, bf16 operands included (the same f32 sums in another
    order)."""
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 24, 64)).astype(np.float32)
    w = (rng.standard_normal((4, 64, 40)) / 8).astype(np.float32)
    jx, jw = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    want = jnp.einsum("ecd,edf->ecf", jx, jw,
                      preferred_element_type=jnp.float32)
    got = tlayers.bmm(*(torch.tensor(a).to(getattr(torch, dtype))
                        for a in (x, w)))
    assert got.dtype == torch.float32
    assert_rel_close(got, np.asarray(want), F32_REL, dtype)
