"""Shared inputs for the training-path parity tests of the PyTorch port.

JAX draws the reduced configuration's f32 weights on a fixed key; they
cross to the port as numpy arrays (``convert.lm_params_from_numpy``).
Batches are drawn with ``np.random.default_rng(seed)`` and handed to both
packages: tokens and next-token targets, or, for the VLM, patch embeddings
on M-RoPE positions (as ``tests/test_archs.py::_batch_for`` feeds it), and
frame embeddings for the encoder-decoder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.launch.steps import make_grad_step
from repro_torch.models import LOCAL

KEY = jax.random.PRNGKey(0)
# the loss: the same f32 formulas with sums in another order; a gradient
# leaf: the backward of two to three f32 layers (measured at most 1.3e-5 of
# the leaf's largest |g|, Jamba's A_log)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
MOE_ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b", "jamba-v0.1-52b")


def lm_pair(arch, **replace):
    """(JAX config, port config, JAX params, numpy tree, port params on the
    CPU) of an arch's reduced configuration with ``replace`` applied."""
    jcfg = j_reduced(arch).replace(**replace)
    tcfg = t_reduced(arch).replace(**replace)
    jp = jt.init_params(jcfg, KEY)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, jp, tree, convert.lm_params_from_numpy(
        tcfg, tree, device="cpu")


def lm_batch(cfg, seed, B, S, *, mask=False, enc_len=12):
    """(JAX batch, port batch) of ``B`` sequences of ``S`` positions with
    targets; with ``mask``, a ``loss_mask`` that drops about a quarter of
    the positions."""
    rng = np.random.default_rng(seed)
    arrays = {"targets": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "vlm":
        arrays["embeds"] = (rng.standard_normal((B, S, cfg.d_model))
                            * 0.02).astype(np.float32)
        arrays["mrope_positions"] = rng.integers(0, S, (3, B, S))
    else:
        arrays["tokens"] = rng.integers(0, cfg.vocab, (B, S))
    if cfg.is_encdec:
        arrays["enc_embeds"] = rng.standard_normal(
            (B, enc_len, cfg.d_model)).astype(np.float32)
    if mask:
        arrays["loss_mask"] = rng.random((B, S)) >= 0.25
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.tensor(v) for k, v in arrays.items()})


def assert_tree_close(got, want, rel, label=""):
    """Every leaf of two JAX-layout numpy trees within ``rel`` of the
    leaf's largest |value|, leaf by leaf, with the same shapes."""
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for (path, w), g in zip(want_leaves, got_leaves):
        name = f"{label}{jax.tree_util.keystr(path)}"
        w = np.asarray(w, np.float32)
        g = np.asarray(g, np.float32)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, f"{name}: max err {err} > {rel} x {scale}"


def check_loss_and_grads(arch, *, mask=True, seed=0, B=2, S=32, **replace):
    """One ``jax.value_and_grad`` against the port's loss and autograd."""
    jcfg, tcfg, jp, _, tp = lm_pair(arch, **replace)
    jb, tb = lm_batch(jcfg, seed, B, S, mask=mask)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jt.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    grads, loss, metrics = make_grad_step(tcfg, LOCAL)(tp, tb)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert float(metrics["nll"]) == pytest.approx(float(jm["nll"]),
                                                  rel=LOSS_RTOL)
    assert float(metrics["aux"]) == pytest.approx(float(jm["aux"]),
                                                  rel=LOSS_RTOL, abs=1e-12)
    assert_tree_close(convert.lm_params_to_numpy(tcfg, grads),
                      jax.tree_util.tree_map(np.asarray, jg), GRAD_RTOL,
                      arch)
