"""Parity of the port's encoder-decoder (Whisper) with the JAX package: the
encoder, the decoder's cross-attention and its cache, and serving.

JAX draws the weights (``init_params`` on a fixed key); they cross to the
port as numpy arrays (``enc_blocks`` / ``dec_blocks`` unstacked into
``enc_layers`` / ``layers``), and both packages see the same numpy-seeded
tokens and frame embeddings, in f32 at the reduced whisper-base
configuration (2 + 2 layers, d 128).  Everything is held within 1e-4 of
the largest value, as ``test_torch_models.py`` holds every model: a few
layers of f32 sums of at most a few hundred terms in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_close
from repro.configs import reduced_config as j_reduced
from repro.models import transformer as jt
from repro.models.sharding import LOCAL
from repro.serving import generate as j_generate
from repro.serving import pad_attn_cache as j_pad
from repro_torch import convert
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import encode
from repro_torch.models import transformer as tt
from repro_torch.serving import generate, pad_attn_cache

KEY = jax.random.PRNGKey(0)
ARCH = "whisper-base"
REL = 1e-4
T_ENC = 24


def setup():
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    jp = jt.init_params(jcfg, KEY)
    tp = convert.lm_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def inputs(seed, B, S, cfg):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    enc = rng.standard_normal((B, T_ENC, cfg.d_model)).astype(np.float32)
    return toks, enc


def batches(toks, enc):
    return ({"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)},
            {"tokens": torch.tensor(toks), "enc_embeds": torch.tensor(enc)})


def test_params_cross_as_encoder_and_decoder_layers():
    jcfg, tcfg, jp, tp = setup()
    assert len(tp["enc_layers"]) == jcfg.encoder_layers
    assert len(tp["layers"]) == jcfg.n_layers
    for layer in tp["enc_layers"]:
        assert "cross" not in layer and "norm_cross" not in layer
    for i, layer in enumerate(tp["layers"]):
        assert sorted(layer["cross"]) == ["wk", "wo", "wq", "wv"]
        np.testing.assert_array_equal(
            layer["cross"]["wq"].numpy(),
            np.asarray(jp["dec_blocks"]["l0"]["cross"]["wq"][i]))
    np.testing.assert_array_equal(tp["enc_final_norm"]["gamma"].numpy(),
                                  np.asarray(jp["enc_final_norm"]["gamma"]))
    with pytest.raises(ValueError, match="layers"):
        convert.lm_params_from_numpy(
            tcfg.replace(n_layers=3),
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_init_params_and_cache_match_jax_structure():
    """The port's own draws have JAX's shapes and dtypes layer by layer
    (the cross attention without q/k norms), and so do its caches,
    cross K/V of ``enc_len`` frames included."""
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_params(jcfg, KEY))
    want = convert.lm_params_from_numpy(tcfg, tree, device="cpu")
    got = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    spec = lambda t: (tuple(t.shape), t.dtype)   # noqa: E731
    assert (jax.tree_util.tree_map(spec, got)
            == jax.tree_util.tree_map(spec, want))
    jc = jax.tree_util.tree_map(np.asarray, jt.init_cache(jcfg, 2, 24, 7))
    tc = tt.init_cache(tcfg, 2, 24, 7, device="cpu")
    assert len(tc["layers"]) == jcfg.n_layers
    for layer in tc["layers"]:
        for path, leaf in jax.tree_util.tree_leaves_with_path(layer):
            jleaf = jc["blocks"]["l0"]
            for p in path:
                jleaf = jleaf[p.key]
            assert tuple(leaf.shape) == jleaf.shape[1:]
            assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype)


def test_encode_matches_jax():
    jcfg, tcfg, jp, tp = setup()
    _, enc = inputs(0, 2, 1, jcfg)
    want = jt.encode(jcfg, jp, jnp.asarray(enc), LOCAL)
    got = encode(tcfg, tp, torch.tensor(enc))
    assert got.shape == (2, T_ENC, jcfg.d_model)
    assert_rel_close(got, want, REL, "encode")


def test_encoder_is_not_causal_and_has_no_positions():
    """Frame t's encoding depends on later frames (no causal mask), and
    permuting the frames permutes the encoding (no positional
    embedding)."""
    _, tcfg, _, tp = setup()
    _, enc = inputs(1, 1, 1, tcfg)
    x = torch.tensor(enc)
    base = encode(tcfg, tp, x)
    late = x.clone()
    late[:, -1] += 1.0
    assert not torch.allclose(encode(tcfg, tp, late)[:, 0], base[:, 0])
    perm = torch.randperm(T_ENC, generator=torch.Generator().manual_seed(0))
    assert_rel_close(encode(tcfg, tp, x[:, perm]), base[:, perm], 1e-5,
                     "permuted frames")


def test_forward_matches_jax():
    jcfg, tcfg, jp, tp = setup()
    jb, tb = batches(*inputs(2, 2, 32, jcfg))
    jl, _, _ = jt.forward(jcfg, jp, jb)
    tl, aux, caches = tt.forward(tcfg, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert float(aux) == 0.0 and caches is None
    assert_rel_close(tl, jl, REL, "logits")


def test_prefill_caches_match_jax():
    """Every decoder layer's self K/V over the prompt and cross K/V over the
    encoded frames."""
    jcfg, tcfg, jp, tp = setup()
    jb, tb = batches(*inputs(3, 2, 20, jcfg))
    jl, jc = jt.prefill(jcfg, jp, jb)
    tl, tc = tt.prefill(tcfg, tp, tb)
    assert_rel_close(tl, jl, REL, "prefill logits")
    for i, layer in enumerate(tc["layers"]):
        want = jc["blocks"]["l0"]
        assert layer["attn"]["k"].shape == (2, 20, jcfg.n_kv, jcfg.hd)
        assert layer["cross"]["ck"].shape == (2, T_ENC, jcfg.n_kv, jcfg.hd)
        for group, names in (("attn", ("k", "v")), ("cross", ("ck", "cv"))):
            for name in names:
                assert_rel_close(layer[group][name], want[group][name][i],
                                 REL, f"layer {i} {group} {name}")


def test_decode_steps_match_jax():
    jcfg, tcfg, jp, tp = setup()
    toks, enc = inputs(4, 2, 24, jcfg)
    S0, n = 20, 4
    jb, tb = batches(toks[:, :S0], enc)
    jl, jc = jt.prefill(jcfg, jp, jb)
    tl, tc = tt.prefill(tcfg, tp, tb)
    jc, tc = j_pad(jc, n), pad_attn_cache(tc, n)
    for i in range(n):
        pos = S0 + i
        jl, jc = jt.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, pos]),
                                jnp.int32(pos))
        tl, tc = tt.decode_step(tcfg, tp, tc, torch.tensor(toks[:, pos]), pos)
        assert tl.shape == (2, 1, jcfg.vocab)
        assert_rel_close(tl, jl, REL, f"decode step {i}")


def test_decode_agrees_with_forward_in_the_port():
    """prefill + decode_step == forward at the last position
    (``tests/test_models.py::_decode_consistency``'s 2e-4)."""
    cfg = t_reduced(ARCH)
    params = tt.init_params(cfg, 3, device="cpu")
    toks, enc = inputs(5, 2, 40, cfg)
    toks, enc = torch.tensor(toks), torch.tensor(enc)
    full, _, _ = tt.forward(cfg, params, {"tokens": toks, "enc_embeds": enc})
    _, cache = tt.prefill(cfg, params, {"tokens": toks[:, :39],
                                        "enc_embeds": enc})
    step, _ = tt.decode_step(cfg, params, pad_attn_cache(cache, 1),
                             toks[:, 39], 39)
    assert_rel_close(step[:, 0], full[:, -1], 2e-4, ARCH)


def test_generate_matches_jax_greedy():
    jcfg, tcfg, jp, tp = setup()
    prompt, enc = inputs(6, 2, 16, jcfg)
    n = 6
    toks = generate(tcfg, tp, torch.tensor(prompt), max_new_tokens=n,
                    enc_embeds=torch.tensor(enc))
    jtoks = j_generate(jcfg, jp, jnp.asarray(prompt), max_new_tokens=n,
                       enc_embeds=jnp.asarray(enc))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


def test_pad_attn_cache_leaves_the_cross_cache_alone():
    """Padding grows only the self-attention K/V (as JAX's walker pads only
    ``attn/{k,v}``); the cross K/V are the prefill's tensors, unpadded, and
    decode steps leave them unchanged."""
    jcfg, tcfg, jp, tp = setup()
    toks, enc = inputs(7, 2, 12, jcfg)
    jb, tb = batches(toks[:, :10], enc)
    _, jc = jt.prefill(jcfg, jp, jb)
    _, tc = tt.prefill(tcfg, tp, tb)
    padded, jpadded = pad_attn_cache(tc, 3), j_pad(jc, 3)
    for i, (layer, old) in enumerate(zip(padded["layers"], tc["layers"])):
        assert layer["cross"] is old["cross"]
        assert layer["attn"]["k"].shape == (2, 13, jcfg.n_kv, jcfg.hd)
        np.testing.assert_array_equal(layer["attn"]["k"][:, 10:].numpy(), 0)
        assert (layer["cross"]["ck"].shape
                == jpadded["blocks"]["l0"]["cross"]["ck"][i].shape)
    before = [{k: v.clone() for k, v in layer["cross"].items()}
              for layer in padded["layers"]]
    cache = padded
    for i in range(2):
        _, cache = tt.decode_step(tcfg, tp, cache,
                                  torch.tensor(toks[:, 10 + i]), 10 + i)
    for layer, old in zip(cache["layers"], before):
        for name in ("ck", "cv"):
            assert torch.equal(layer["cross"][name], old[name])
