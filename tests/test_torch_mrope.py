"""Parity of the port's Qwen2-VL multimodal RoPE (``layers.apply_mrope``)
and of the VLM model on M-RoPE positions with the JAX package.

Both packages see the same numpy-seeded activations, patch embeddings and
position streams; the model's weights are JAX's draws handed over as numpy
arrays, in f32 at the reduced Qwen2-VL configuration (2 layers, head width
32, sections (4, 6, 6)).  The rotation is held within 1e-6 of the largest
value (f32 angles and sines computed by two libraries); the model within
1e-4 of the largest logit, as ``test_torch_models.py`` holds every model.
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
from repro.serving import pad_attn_cache as j_pad
from repro_torch import convert
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt
from repro_torch.serving import pad_attn_cache

KEY = jax.random.PRNGKey(0)
ARCH = "qwen2-vl-7b"
ROPE_REL = 1e-6
MODEL_REL = 1e-4


def image_positions(B, n_text, grid, n_after):
    """Qwen2-VL's position streams (3, B, S) for text, a grid x grid image,
    then text: text t = h = w = index; image t = start, h = start + row,
    w = start + col; the text after it resumes at the largest position + 1.
    """
    text = np.arange(n_text)
    start = n_text
    rows, cols = np.divmod(np.arange(grid * grid), grid)
    img = np.stack([np.full(grid * grid, start), start + rows, start + cols])
    after = start + grid + np.arange(n_after)
    pos = np.concatenate([np.stack([text] * 3), img,
                          np.stack([after] * 3)], axis=1)
    return np.broadcast_to(pos[:, None], (3, B, pos.shape[1])).copy()


def test_image_positions_follow_qwen2_vl():
    pos = image_positions(1, 3, 2, 2)[:, 0]
    np.testing.assert_array_equal(pos, [[0, 1, 2, 3, 3, 3, 3, 5, 6],
                                        [0, 1, 2, 3, 3, 4, 4, 5, 6],
                                        [0, 1, 2, 3, 4, 3, 4, 5, 6]])


@pytest.mark.parametrize("sections,theta", [((4, 6, 6), 1e6),
                                            ((16, 24, 24), 1e6),
                                            ((2, 3, 3), 1e4)])
def test_apply_mrope_matches_jax(sections, theta):
    rng = np.random.default_rng(sum(sections))
    hd = 2 * sum(sections)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 300, (3, 2, 9))
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                               theta, sections)
    got = tlayers.apply_mrope(torch.tensor(x), torch.tensor(pos), theta,
                              sections)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert_rel_close(got, want, ROPE_REL, "mrope")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_equal_streams_are_rope_bit_for_bit(dtype):
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.standard_normal((2, 7, 4, 32))).to(dtype)
    pos = torch.tensor(rng.integers(0, 500, (2, 7)))
    got = tlayers.apply_mrope(x, pos.expand(3, -1, -1), 1e6, (4, 6, 6))
    for p in (pos, pos[:1]):
        want = tlayers.apply_rope(x[:p.shape[0]], p, 1e6)
        assert torch.equal(got[:p.shape[0]], want)


def test_apply_mrope_refuses_sections_that_miss_half_the_head():
    x = torch.zeros((1, 2, 1, 32))
    with pytest.raises(ValueError, match="cover hd/2"):
        tlayers.apply_mrope(x, torch.zeros((3, 1, 2), dtype=torch.long),
                            1e6, (4, 6, 4))


def setup():
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    jp = jt.init_params(jcfg, KEY)
    tp = convert.lm_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def image_batch(seed, cfg, B=2, n_text=8, grid=4, n_after=8):
    """Text-token embeddings around a grid of patch embeddings (seeded
    normal x 0.02, as ``tests/test_archs.py`` draws them), with the image
    position streams."""
    rng = np.random.default_rng(seed)
    S = n_text + grid * grid + n_after
    toks = rng.integers(0, cfg.vocab, (B, S))
    patches = (rng.standard_normal((B, grid * grid, cfg.d_model))
               * 0.02).astype(np.float32)
    return toks, patches, image_positions(B, n_text, grid, n_after)


def embed(params, toks, patches, n_text):
    """The tokens' embeddings with the patches in place after n_text."""
    e = np.asarray(params["embed"])[toks]
    e[:, n_text:n_text + patches.shape[1]] = patches
    return e


def test_image_forward_matches_jax():
    jcfg, tcfg, jp, tp = setup()
    toks, patches, pos = image_batch(1, jcfg)
    e = embed(jp, toks, patches, 8)
    jl, _, _ = jt.forward(jcfg, jp, {"embeds": jnp.asarray(e),
                                     "mrope_positions":
                                         jnp.asarray(pos, jnp.int32)})
    tl, _, _ = tt.forward(tcfg, tp, {"embeds": torch.tensor(e),
                                     "mrope_positions": torch.tensor(pos)})
    assert_rel_close(tl, jl, MODEL_REL, "image forward")
    # the image's positions matter: 1-D positions give other logits
    tl1, _, _ = tt.forward(tcfg, tp, {"embeds": torch.tensor(e)})
    assert float((tl1 - tl).abs().max()) > 1e2 * MODEL_REL * float(
        tl.abs().max())


def test_embeds_with_equal_streams_are_the_tokens_forward():
    _, tcfg, _, tp = setup()
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 20))
    t = torch.tensor(toks)
    pos = torch.arange(20)[None, None].expand(3, 2, 20)
    got, _, _ = tt.forward(tcfg, tp, {"embeds": tp["embed"][t],
                                      "mrope_positions": pos})
    want, _, _ = tt.forward(tcfg, tp, {"tokens": t})
    assert torch.equal(got, want)


def test_decode_after_an_image_prefill_matches_jax():
    """Both prefill the image batch on M-RoPE positions, then decode at the
    next write slots with 1-D RoPE (the reference passes no M-RoPE
    positions in decode)."""
    jcfg, tcfg, jp, tp = setup()
    toks, patches, pos = image_batch(3, jcfg)
    S0 = toks.shape[1]
    e = embed(jp, toks, patches, 8)
    jl, jc = jt.prefill(jcfg, jp, {"embeds": jnp.asarray(e),
                                   "mrope_positions":
                                       jnp.asarray(pos, jnp.int32)})
    tl, tc = tt.prefill(tcfg, tp, {"embeds": torch.tensor(e),
                                   "mrope_positions": torch.tensor(pos)})
    assert_rel_close(tl, jl, MODEL_REL, "image prefill")
    for i, layer in enumerate(tc["layers"]):
        want = jc["blocks"]["l0"]["attn"]["k"][i]
        assert_rel_close(layer["attn"]["k"], want, MODEL_REL,
                         f"layer {i} k (rotated by M-RoPE)")
    n = 3
    jc, tc = j_pad(jc, n), pad_attn_cache(tc, n)
    nxt = np.random.default_rng(4).integers(0, jcfg.vocab, (2, n))
    for i in range(n):
        jl, jc = jt.decode_step(jcfg, jp, jc, jnp.asarray(nxt[:, i]),
                                jnp.int32(S0 + i))
        tl, tc = tt.decode_step(tcfg, tp, tc, torch.tensor(nxt[:, i]),
                                S0 + i)
        assert_rel_close(tl, jl, MODEL_REL, f"decode step {i}")
