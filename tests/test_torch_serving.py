"""Parity of the port's serving engine (``repro_torch.serving``) and its
launcher (``repro_torch.launch.serve``) with the JAX package.

Both packages generate greedily from the same weights (JAX's draws, handed
over as numpy arrays) and prompt.  The port returns the logits each token
was drawn from; JAX's are recomputed teacher-forced on the port's tokens
(JAX prefill + ``decode_step``), and every step's logits are held within
1e-4 of the largest logit (f32, sums in another order; see
``test_torch_models.py``).  Tokens must equal JAX ``generate``'s wherever
the top two logits of a step are further apart than that tolerance, so a
near tie cannot flip the verdict.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import transformer as jt
from repro.serving import generate as j_generate
from repro.serving import pad_attn_cache as j_pad
from repro_torch import convert
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.launch import serve
from repro_torch.models import transformer as tt
from repro_torch.serving import generate, pad_attn_cache

KEY = jax.random.PRNGKey(0)
TOL = 1e-4
ARCHS = ["qwen3-0.6b", "rwkv6-7b", "deepseek-moe-16b", "kimi-k2-1t-a32b"]


def setup(arch, B=2, S=36):
    jcfg, tcfg = j_reduced(arch), t_reduced(arch)
    jp = jt.init_params(jcfg, KEY)
    tp = convert.lm_params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab, (B, S))
    return jcfg, tcfg, jp, tp, prompt


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    jcfg, tcfg, jp, tp, prompt = setup(arch)
    n = 6
    toks, logits = generate(tcfg, tp, torch.tensor(prompt), max_new_tokens=n,
                            return_logits=True)
    assert toks.shape == (2, n) and logits.shape == (2, n, jcfg.vocab)
    toks = toks.numpy()

    # JAX's logits, teacher-forced on the port's tokens
    S0 = prompt.shape[1]
    jl, cache = jt.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)})
    cache = j_pad(cache, n)
    want = [np.asarray(jl[:, -1])]
    for i in range(n - 1):
        jl, cache = jt.decode_step(jcfg, jp, cache, jnp.asarray(toks[:, i]),
                                   jnp.int32(S0 + i))
        want.append(np.asarray(jl[:, -1]))
    want = np.stack(want, axis=1)
    scale = float(np.abs(want).max())
    err = float(np.abs(logits.numpy() - want).max())
    assert err <= TOL * scale, (err, scale)

    jtoks = np.asarray(j_generate(jcfg, jp, jnp.asarray(prompt),
                                  max_new_tokens=n))
    top2 = -np.sort(-want, axis=-1)[..., :2]
    clear = np.cumprod(top2[..., 0] - top2[..., 1] > 2 * TOL * scale,
                       axis=1).astype(bool)
    assert clear[:, 0].all()
    np.testing.assert_array_equal(toks[clear], jtoks[clear])


def test_pad_attn_cache_matches_jax():
    jcfg, tcfg, jp, tp, prompt = setup("qwen3-0.6b", S=8)
    _, jc = jt.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)})
    _, tc = tt.prefill(tcfg, tp, {"tokens": torch.tensor(prompt)})
    jc, tc = j_pad(jc, 3), pad_attn_cache(tc, 3)
    for i, layer in enumerate(tc["layers"]):
        for name in ("k", "v"):
            got = layer["attn"][name].numpy()
            want = np.asarray(jc["blocks"]["l0"]["attn"][name][i])
            assert got.shape == (2, 11, jcfg.n_kv, jcfg.hd)
            np.testing.assert_array_equal(got[:, 8:], 0.0)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sampling_draws_from_the_generator():
    _, tcfg, _, tp, prompt = setup("rwkv6-7b", S=4)
    draws = [generate(tcfg, tp, torch.tensor(prompt), max_new_tokens=5,
                      temperature=0.8,
                      generator=torch.Generator().manual_seed(seed))
             for seed in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1])
    assert all(((d >= 0) & (d < tcfg.vocab)).all() for d in draws)
    stats = {}
    generate(tcfg, tp, torch.tensor(prompt), max_new_tokens=2, stats=stats)
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


@pytest.mark.parametrize("arch", ARCHS + ["jamba-v0.1-52b", "qwen2-vl-7b",
                                          "whisper-base"])
def test_serve_cli_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                      "--prompt-len", "20", "--new-tokens", "3",
                      "--device", "cpu"])
    assert out.shape == (2, 3)
    assert ((out >= 0) & (out < t_reduced(arch).vocab)).all()
    printed = capsys.readouterr().out
    assert f"[serve] {arch} on cpu" in printed and "tok/s" in printed
