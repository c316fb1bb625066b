"""Parity of the port's Mamba mixer (``repro_torch.models.mamba``) and of
Jamba's hybrid interleave with the JAX package, on the same weights.

JAX draws the weights (``mamba_init`` / ``init_params`` on a fixed key);
they cross to the port as numpy arrays, and both packages see the same
numpy-seeded inputs, in f32 at the reduced Jamba configuration.  The scan
is held within 1e-5 of JAX's and of the naive recurrence (the JAX test's
own bound, ``tests/test_models.py:104``): the doubling scan and JAX's
``associative_scan`` reorder the same products and sums.  The mixer is
held within 1e-5 of its largest output (f32 products of at most 256 terms
in another order); Jamba's logits within 1e-4 of the largest, as
``test_torch_models.py`` holds every model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_rel_close
from repro.configs import reduced_config as j_reduced
from repro.models import mamba as jmamba
from repro.models import transformer as jt
from repro.serving import generate as j_generate
from repro.serving import pad_attn_cache as j_pad
from repro_torch import convert
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import mamba as tmamba
from repro_torch.models import transformer as tt
from repro_torch.serving import generate, pad_attn_cache

KEY = jax.random.PRNGKey(0)
ARCH = "jamba-v0.1-52b"
SCAN_TOL = 1e-5
MIXER_REL = 1e-5
MODEL_REL = 1e-4


def scan_inputs(seed, B=2, T=64, d_in=8, N=4):
    rng = np.random.default_rng(seed)
    decay = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, d_in, N))))
    inc = rng.standard_normal((B, T, d_in, N)) * 0.1
    h0 = rng.standard_normal((B, d_in, N))
    return tuple(a.astype(np.float32) for a in (decay, inc, h0))


def naive_scan(decay, inc, h0):
    h, outs = h0, []
    for t in range(decay.shape[1]):
        h = decay[:, t] * h + inc[:, t]
        outs.append(h)
    return torch.stack(outs, dim=1)


@pytest.mark.parametrize("chunk,loops", [(16, "scan"), (32, "unroll")])
def test_ssm_scan_matches_jax_and_the_recurrence(chunk, loops):
    decay, inc, h0 = scan_inputs(chunk)
    jys, jh = jmamba._ssm_scan_chunked(*map(jnp.asarray, (decay, inc, h0)),
                                       chunk=chunk, loops=loops)
    td, ti, th = map(torch.tensor, (decay, inc, h0))
    ys, h = tmamba._ssm_scan_chunked(td, ti, th, chunk=chunk)
    assert ys.shape == td.shape and h.shape == th.shape
    ref = naive_scan(td, ti, th).numpy()
    for got, want in ((ys, np.asarray(jys)), (h, np.asarray(jh)),
                      (ys, ref), (h, ref[:, -1])):
        np.testing.assert_allclose(got.numpy(), want, rtol=SCAN_TOL,
                                   atol=SCAN_TOL)


def test_ssm_scan_stays_exact_where_the_decays_underflow():
    """At Jamba's steepest decays (dt 0.1, A = -16: 0.2 a step) a chunk of
    64 multiplies to about 1e-45, below f32's smallest normal number; the
    chunked scan must still follow the recurrence (no division by a
    cumulative decay)."""
    decay, inc, h0 = scan_inputs(7, T=128)
    decay = np.full_like(decay, np.float32(np.exp(-1.6)))
    assert np.prod(decay[0, :64, 0, 0].astype(np.float64)) < 1.2e-38
    td, ti, th = map(torch.tensor, (decay, inc, h0))
    ys, h = tmamba._ssm_scan_chunked(td, ti, th, chunk=64)
    ref = naive_scan(td, ti, th).numpy()
    assert np.isfinite(ys.numpy()).all()
    np.testing.assert_allclose(ys.numpy(), ref, rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), ref[:, -1], rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def test_ssm_scan_refuses_a_chunk_that_does_not_divide_t():
    td, ti, th = map(torch.tensor, scan_inputs(0, T=48))
    with pytest.raises(ValueError, match="does not divide"):
        tmamba._ssm_scan_chunked(td, ti, th, chunk=32)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(with_tail):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    tail = (rng.standard_normal((2, 3, 16)) if with_tail
            else np.zeros((2, 3, 16))).astype(np.float32)
    jout, jtail = jmamba._causal_conv(*map(jnp.asarray, (x, w, b, tail)))
    out, new_tail = tmamba._causal_conv(*map(torch.tensor, (x, w, b, tail)))
    assert_rel_close(out, jout, 1e-6, "conv")
    np.testing.assert_array_equal(new_tail.numpy(), np.asarray(jtail))
    np.testing.assert_array_equal(new_tail.numpy(), x[:, -3:])


def mixer_pair():
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    jp = jmamba.mamba_init(jcfg, KEY)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def test_mamba_init_matches_jax_structure():
    """Shapes and dtypes of the port's own draws are JAX's (values match in
    distribution only); ``A_log``, ``D`` and ``dt_bias`` stay f32 in a bf16
    model, and dt = softplus(dt_bias) lies in [0.001, 0.1]."""
    for dtype in ("float32", "bfloat16"):
        jcfg = j_reduced(ARCH).replace(param_dtype=dtype)
        tcfg = t_reduced(ARCH).replace(param_dtype=dtype)
        jp = jmamba.mamba_init(jcfg, KEY)
        tp = tmamba.mamba_init(tcfg, torch.Generator().manual_seed(0))
        assert sorted(tp) == sorted(jp)
        for k, v in jp.items():
            assert tuple(tp[k].shape) == v.shape, k
            assert str(tp[k].dtype).split(".")[-1] == str(v.dtype), k
        dt = torch.nn.functional.softplus(tp["dt_bias"])
        assert float(dt.min()) >= 0.001 * (1 - 1e-5)
        assert float(dt.max()) <= 0.1 * (1 + 1e-5)
        # log(1..N), one f32 rounding apart at most
        np.testing.assert_allclose(tp["A_log"].numpy(),
                                   np.asarray(jp["A_log"]), rtol=1.2e-7)


@pytest.mark.parametrize("T,chunk,carried", [(32, 16, False), (32, 8, True),
                                             (1, 1, True)])
def test_mamba_mixer_matches_jax(T, chunk, carried):
    """From no state, from a carried state (h and the conv tail), and one
    decode step (T = 1)."""
    jcfg, tcfg, jp, tp = mixer_pair()
    rng = np.random.default_rng(T + chunk)
    d_in, N = jcfg.mamba.expand * jcfg.d_model, jcfg.mamba.d_state
    x = rng.standard_normal((2, T, jcfg.d_model)).astype(np.float32)
    state = None
    jstate = None
    if carried:
        h = rng.standard_normal((2, d_in, N)).astype(np.float32)
        conv = rng.standard_normal((2, jcfg.mamba.d_conv - 1, d_in))
        conv = conv.astype(np.float32)
        jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        state = {"h": torch.tensor(h), "conv": torch.tensor(conv)}
    jout, jst = jmamba.mamba_mixer(jcfg, jp, jnp.asarray(x), jstate,
                                   chunk=chunk)
    out, st = tmamba.mamba_mixer(tcfg, tp, torch.tensor(x), state,
                                 chunk=chunk)
    assert out.dtype == torch.float32 and out.shape == jout.shape
    assert_rel_close(out, jout, MIXER_REL, "out")
    assert st["h"].dtype == torch.float32
    assert_rel_close(st["h"], jst["h"], MIXER_REL, "h")
    # the tail's new rows are in_proj outputs: f32 sums in another order
    assert_rel_close(st["conv"], jst["conv"], MIXER_REL, "conv tail")


def model_pair():
    jcfg, tcfg = j_reduced(ARCH), t_reduced(ARCH)
    jp = jt.init_params(jcfg, KEY)
    tp = convert.lm_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_jamba_layers_interleave_as_the_reference():
    """The flat layer list follows the super-block: attention at in-block
    offset 4, Mamba elsewhere, MoE on odd layers."""
    _, tcfg, jp, tp = model_pair()
    kinds = tcfg.layer_kinds()
    assert [m for m, _ in kinds] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [f for _, f in kinds] == ["dense", "moe"] * 4
    for layer, (mixer, ffn) in zip(tp["layers"], kinds):
        assert ("A_log" in layer["mixer"]) == (mixer == "mamba")
        assert ("router" in layer["ffn"]) == (ffn == "moe")


def test_jamba_forward_and_prefill_caches_match_jax():
    """T = 48 runs the mixer at chunk gcd(48, 64) = 16 (three chunks)."""
    jcfg, tcfg, jp, tp = model_pair()
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 48))
    jl, jaux, jc = jt.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                              collect=True)
    tl, aux, tc = tt.forward(tcfg, tp, {"tokens": torch.tensor(toks)},
                             collect=True)
    assert_rel_close(tl, jl, MODEL_REL, "logits")
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    for i, layer in enumerate(tc["layers"]):
        want = jc["blocks"][f"l{i}"]
        if "mamba" in layer:
            assert_rel_close(layer["mamba"]["h"], want["mamba"]["h"][0],
                             MODEL_REL, f"layer {i} h")
            assert_rel_close(layer["mamba"]["conv"], want["mamba"]["conv"][0],
                             MODEL_REL, f"layer {i} conv")
        else:
            for name in ("k", "v"):
                assert_rel_close(layer["attn"][name], want["attn"][name][0],
                                 MODEL_REL, f"layer {i} {name}")


def test_jamba_decode_steps_match_jax():
    jcfg, tcfg, jp, tp = model_pair()
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 23))
    S0, n = 20, 3
    jl, jc = jt.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :S0])})
    tl, tc = tt.prefill(tcfg, tp, {"tokens": torch.tensor(toks[:, :S0])})
    assert_rel_close(tl, jl, MODEL_REL, "prefill")
    jc, tc = j_pad(jc, n), pad_attn_cache(tc, n)
    for i in range(n):
        pos = S0 + i
        jl, jc = jt.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, pos]),
                                jnp.int32(pos))
        tl, tc = tt.decode_step(tcfg, tp, tc, torch.tensor(toks[:, pos]), pos)
        assert_rel_close(tl, jl, MODEL_REL, f"decode step {i}")
        assert_rel_close(tc["layers"][0]["mamba"]["h"],
                         jc["blocks"]["l0"]["mamba"]["h"][0], MODEL_REL,
                         f"decode step {i} h")


def test_jamba_decode_agrees_with_forward_in_the_port():
    """prefill + decode_step == forward at the last position: the prefill
    runs chunk 8 (T = 40), the 41-token forward chunk 1, so the scan's two
    forms meet (``tests/test_models.py::_decode_consistency``'s 2e-4)."""
    cfg = t_reduced(ARCH)
    params = tt.init_params(cfg, 3, device="cpu")
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab,
                                                          (2, 41)))
    full, _, _ = tt.forward(cfg, params, {"tokens": toks})
    _, cache = tt.prefill(cfg, params, {"tokens": toks[:, :40]})
    step, _ = tt.decode_step(cfg, params, pad_attn_cache(cache, 1),
                             toks[:, 40], 40)
    assert_rel_close(step[:, 0], full[:, -1], 2e-4, ARCH)


def test_jamba_generate_matches_jax_greedy():
    jcfg, tcfg, jp, tp = model_pair()
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 24))
    n = 5
    toks = generate(tcfg, tp, torch.tensor(prompt), max_new_tokens=n)
    jtoks = j_generate(jcfg, jp, jnp.asarray(prompt), max_new_tokens=n)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
