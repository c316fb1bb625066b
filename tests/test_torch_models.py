"""Parity of the port's language models (``repro_torch.models``) with the JAX
package, on the same weights.

JAX draws the weights (``init_params`` on a fixed key); they cross to the
port as numpy arrays through ``repro_torch.convert.lm_params_from_numpy``,
and both packages see the same numpy-seeded tokens.  Everything runs in f32
at the reduced configurations, where both compute the same formulas and
differ only in the order of their sums, so logits are held within 1e-4 of
the largest logit: two to three layers of f32 sums of at most a few
hundred terms, RWKV's cumulative decays through exponentials included.
The MoE families route in f32 on both sides; a near tie in a top-k choice
would flip one expert and move the logits far past that bound, and none
occurs at these seeds (their reduced capacity factor, 4.0, drops nothing).
The layers (norms, RoPE, MLPs) are held within 1e-6 relative.  Lengths are
picked for the paths the models take: T = 48 runs the chunked attention
(chunk 16 divides it), RWKV's chunked WKV (chunk gcd(48, 256) = 16) and
Jamba's chunked Mamba scan (chunk gcd(48, 64) = 16).  The encoder-decoder
also gets numpy-seeded frame embeddings (``enc_embeds``); the VLM runs on
tokens here, as ``generate`` drives it (``test_torch_mrope.py`` covers its
M-RoPE positions).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_close
from repro.configs import reduced_config as j_reduced
from repro.models import layers as jlayers
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JConfig
from repro.serving import pad_attn_cache as j_pad
from repro_torch import convert
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serving import pad_attn_cache as t_pad

KEY = jax.random.PRNGKey(0)
PORTED = ARCH_IDS
# the MoE load-balance loss: a mean over T*E f32 products of softmax
# probabilities, summed over the MoE layers, in another order
AUX_RTOL = 1e-5


def model_pair(arch):
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = jt.init_params(jcfg, KEY)
    tp = convert.lm_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def tokens(seed, B, T, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, T))


def batch_pair(cfg, toks, seed=0):
    """(JAX batch, port batch) over ``toks``; the encoder-decoder's also
    hold 12 numpy-seeded frames."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks)}
    if cfg.is_encdec:
        enc = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], 12, cfg.d_model)).astype(np.float32)
        jb["enc_embeds"] = jnp.asarray(enc)
        tb["enc_embeds"] = torch.tensor(enc)
    return jb, tb


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jp, tp = model_pair(arch)
    jb, tb = batch_pair(jcfg, tokens(1, 2, 48, jcfg.vocab))
    jl, jaux, _ = jt.forward(jcfg, jp, jb)
    tl, aux, caches = tt.forward(tcfg, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert aux.dtype == torch.float32 and caches is None
    if jcfg.moe is None:
        assert float(aux) == float(jaux) == 0.0
    else:
        assert float(jaux) > 0.0
        assert float(aux) == pytest.approx(float(jaux), rel=AUX_RTOL)
    assert_rel_close(tl, jl, 1e-4, arch)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_jax_teacher_forced(arch):
    """Both packages prefill 20 tokens and decode the next 4 given tokens;
    the logits of every step agree."""
    jcfg, tcfg, jp, tp = model_pair(arch)
    toks = tokens(2, 2, 24, jcfg.vocab)
    S0, n = 20, 4
    jb, tb = batch_pair(jcfg, toks[:, :S0])
    jl, jc = jt.prefill(jcfg, jp, jb)
    tl, tc = tt.prefill(tcfg, tp, tb)
    assert_rel_close(tl, jl, 1e-4, "prefill")
    jc, tc = j_pad(jc, n), t_pad(tc, n)
    for i in range(n):
        pos = S0 + i
        jl, jc = jt.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, pos]),
                                jnp.int32(pos))
        tl, tc = tt.decode_step(tcfg, tp, tc, torch.tensor(toks[:, pos]), pos)
        assert tl.shape == (2, 1, jcfg.vocab)
        assert_rel_close(tl, jl, 1e-4, f"decode step {i}")


def test_decode_agrees_with_forward_in_the_port():
    """prefill + decode_step == forward at the last position (the JAX
    test's own check, ``tests/test_models.py::_decode_consistency``)."""
    for arch in ("qwen3-0.6b", "rwkv6-7b", "deepseek-moe-16b"):
        cfg = t_reduced(arch)
        params = tt.init_params(cfg, 3, device="cpu")
        toks = torch.tensor(tokens(4, 2, 40, cfg.vocab))
        full, _, _ = tt.forward(cfg, params, {"tokens": toks})
        _, cache = tt.prefill(cfg, params, {"tokens": toks[:, :39]})
        step, _ = tt.decode_step(cfg, params, t_pad(cache, 1),
                                 toks[:, 39], 39)
        assert_rel_close(step[:, 0], full[:, -1], 2e-4, arch)


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    gamma = rng.standard_normal(32).astype(np.float32)
    beta = rng.standard_normal(32).astype(np.float32)
    tx, tg, tb = (torch.tensor(a) for a in (x, gamma, beta))
    assert_rel_close(tlayers.rmsnorm(tx, tg, 1e-6),
                     jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(gamma), 1e-6),
                     1e-6, "rmsnorm")
    assert_rel_close(tlayers.layernorm(tx, tg, tb),
                     jlayers.layernorm(jnp.asarray(x), jnp.asarray(gamma),
                                       jnp.asarray(beta)), 1e-6, "layernorm")
    pos = np.arange(6)[None]
    assert_rel_close(tlayers.apply_rope(tx, torch.tensor(pos), 1e6),
                     jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
                     1e-6, "rope")
    pos = np.array([[37]])
    assert_rel_close(tlayers.apply_rope(tx[:, :1], torch.tensor(pos), 1e4),
                     jlayers.apply_rope(jnp.asarray(x[:, :1]),
                                        jnp.asarray(pos), 1e4),
                     1e-6, "rope at a decode position")
    for act in ("swiglu", "gelu"):
        jcfg = JConfig(name="t", family="dense", n_layers=1, d_model=32,
                       n_heads=2, n_kv=2, d_ff=48, vocab=8, act=act,
                       dtype="float32", param_dtype="float32")
        tcfg = TConfig(**{f: getattr(jcfg, f)
                          for f in jcfg.__dataclass_fields__})
        jp = jlayers.mlp_init(jcfg, KEY)
        if act == "gelu":      # nonzero biases
            jp = {**jp, "bu": jnp.asarray(rng.standard_normal(48), jnp.float32),
                  "bd": jnp.asarray(rng.standard_normal(32), jnp.float32)}
        tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
        h = rng.standard_normal((2, 5, 32)).astype(np.float32)
        assert_rel_close(tlayers.mlp_apply(tcfg, tp, torch.tensor(h)),
                         jlayers.mlp_apply(jcfg, jp, jnp.asarray(h)), 1e-6, act)


@pytest.mark.parametrize("lead", [(64,), (4, 16)])
def test_dot_keeps_the_f32_result_of_bf16_operands(lead):
    """JAX's ``dot`` asks for an f32 result; the port's must not round the
    bf16 product to bf16 on the way.  bf16 (64 x 1024) . (1024 x 512) from
    numpy seed 0 agree within 1e-5 of max |out| (the same f32 sums in
    another order; a bf16-rounded result departs by about 2e-3), and the
    result is f32 whatever the leading axes."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((*lead, 1024)).astype(np.float32)
    w = (rng.standard_normal((1024, 512)) * 1024 ** -0.5).astype(np.float32)
    jx, jw = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    tx, tw = (torch.tensor(a).bfloat16() for a in (x, w))
    want = np.asarray(jlayers.dot(jx, jw), np.float64)
    got = tlayers.dot(tx, tw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = float(np.abs(got.double().numpy() - want).max()
                / np.abs(want).max())
    assert err <= 1e-5, err


def test_dot_keeps_f32_and_mixed_operands_as_before():
    """f32 and mixed-dtype operands promote, multiply in the promoted
    dtype and return f32, bit for bit as ``torch.matmul`` gives them."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((3, 5, 32)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((32, 24)), dtype=torch.float32)
    for a, b in ((x, w), (x.bfloat16(), w), (x, w.bfloat16()),
                 (x.double(), w)):
        dt = torch.promote_types(a.dtype, b.dtype)
        got = tlayers.dot(a, b)
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.matmul(a.to(dt), b.to(dt)).float())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b",
                                  "deepseek-moe-16b", "jamba-v0.1-52b",
                                  "qwen2-vl-7b"])
def test_init_params_and_cache_match_jax_structure(arch):
    """The port's own draws have JAX's shapes and dtypes, layer by layer
    (values match in distribution only), and so do its caches, the MoE
    families' dense head layers first and Jamba's super-block layer by
    layer."""
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jcfg, KEY))
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    want = convert.lm_params_from_numpy(tcfg, jp, device="cpu")
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                    want)
    assert jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                  tp) == shapes
    jc = jax.tree_util.tree_map(np.asarray, jt.init_cache(jcfg, 2, 24))
    tc = tt.init_cache(tcfg, 2, 24, device="cpu")
    first = jcfg.moe.first_k_dense if jcfg.moe else 0
    assert len(jc["head"]) == first
    for i, layer in enumerate(tc["layers"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(layer):
            keys = [p.key for p in path]
            jleaf = (jc["head"][i] if i < first else
                     jc["blocks"][f"l{(i - first) % jcfg.block_len}"])
            for k in keys:
                jleaf = jleaf[k]
            want = jleaf.shape if i < first else jleaf.shape[1:]
            assert tuple(leaf.shape) == want, keys
            assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype), keys


def test_families_not_ported_raise():
    """Every family is ported, the training loss included: each reduced
    configuration builds, with one layer a ``layer_kinds()`` entry, and
    ``loss_fn`` gives a finite f32 loss for it (nothing raises any more;
    ``test_torch_loss.py`` holds the loss and its gradients to JAX's)."""
    for arch in ARCH_IDS:
        cfg = t_reduced(arch)
        params = tt.init_params(cfg, 0, device="cpu")
        assert len(params["layers"]) == cfg.n_layers
        assert len(params.get("enc_layers", [])) == cfg.encoder_layers
        toks = torch.tensor(tokens(6, 2, 16, cfg.vocab))
        batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
        if cfg.is_encdec:
            batch["enc_embeds"] = torch.zeros((2, 12, cfg.d_model))
        with torch.no_grad():
            loss, metrics = tt.loss_fn(cfg, params, batch)
        assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
        assert set(metrics) == {"nll", "aux"}


def test_bf16_weights_cross_unchanged():
    """JAX's bf16 weights (numpy arrays of ml_dtypes' bfloat16) arrive as
    torch bfloat16 tensors with the same values, and ``dtype`` casts."""
    jcfg = j_reduced("rwkv6-7b").replace(param_dtype="bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, jt.init_params(jcfg, KEY))
    tcfg = t_reduced("rwkv6-7b").replace(param_dtype="bfloat16")
    tp = convert.lm_params_from_numpy(tcfg, tree, device="cpu")
    want = tree["blocks"]["l0"]["mixer"]["rwkv_wk"][1]
    got = tp["layers"][1]["mixer"]["rwkv_wk"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    assert tp["layers"][0]["mixer"]["w0"].dtype == torch.float32
    tp32 = convert.lm_params_from_numpy(tcfg, tree, device="cpu",
                                        dtype=torch.float32)
    assert tp32["embed"].dtype == torch.float32


def test_constructors_default_to_the_card(monkeypatch):
    """Without CUDA, the model constructors refuse their default device and
    work when asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_reduced("qwen3-0.6b")
    tree = jax.tree_util.tree_map(np.asarray,
                                  jt.init_params(j_reduced("qwen3-0.6b"), KEY))
    calls = [lambda **kw: tt.init_params(cfg, 0, **kw),
             lambda **kw: tt.init_cache(cfg, 1, 4, **kw),
             lambda **kw: convert.lm_params_from_numpy(cfg, tree, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
        call(device="cpu")
    with pytest.raises(ValueError, match="layers"):
        convert.lm_params_from_numpy(cfg.replace(n_layers=3), tree,
                                     device="cpu")
