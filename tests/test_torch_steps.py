"""Parity of the port's step builders (``repro_torch.launch.steps``) with
JAX's ``repro.launch.steps``, and of the parameter layouts crossing
between the packages (``convert.lm_params_{from,to}_numpy``).

``make_train_step`` runs against JAX's ``make_train_step(cfg, LOCAL, oc)``
on the reduced f32 configurations of Qwen3-0.6B (tied embeddings),
RWKV6-7B and Qwen2-VL-7B (``mrope_positions`` carry the batch on axis 1,
so the microbatch split moves that axis), at ``grad_accum`` 1 and 2, with
the f32 state tier.  The loss and the global gradient norm are held within
1e-5 relative and the moments within 1e-4 of each leaf's largest value
(the gradients' own tolerance, ``test_torch_loss.py``).  The first AdamW
step moves a parameter by lr * g / (|g| + eps), about lr * sign(g), so
where |g| lies within the two packages' rounding of zero the two updates
may differ by up to 2 lr: every parameter is held within 2 lr (plus the
weight decay's share) of JAX's, and those whose first moment is at least
1e-3 of its leaf's largest within 1e-3 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal
from _torch_lm import lm_batch, lm_pair
from repro.launch import steps as jsteps
from repro.models.sharding import LOCAL
from repro.optim import adamw as ja
from repro_torch import convert
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt
from repro_torch.models.sharding import LOCAL as TLOCAL
from repro_torch.optim import adamw as ta
from repro_torch.utils import tree_leaves

LR = 1e-3


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b", "qwen2-vl-7b"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(arch, accum):
    jcfg, tcfg, jp, tree, tp = lm_pair(arch, grad_accum=accum)
    jb, tb = lm_batch(jcfg, 11, 4, 16, mask=True)
    oc = ja.OptConfig(lr=LR, schedule="const", warmup_steps=1)
    toc = ta.OptConfig(**oc.__dict__)
    jp2, js2, jm = jsteps.make_train_step(jcfg, LOCAL, oc)(
        jp, ja.adamw_init(jp, oc), jb)
    tp2, ts2, tm = tsteps.make_train_step(tcfg, TLOCAL, toc)(
        tp, ta.adamw_init(tp, toc), tb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert float(tm["lr"]) == float(jm["lr"])
    want_mu = jax.tree_util.tree_map(np.asarray, js2["mu"])
    got_mu = convert.opt_state_to_numpy(tcfg, ts2)["mu"]
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_mu),
                            _leaves(got_mu)):
        scale = max(float(np.abs(w).max()), 1e-30)
        rel = 1e-4 if path[-1].key in ("m", "v") else None
        if rel is not None:
            assert float(np.abs(g - w).max()) <= rel * scale, path
    new = convert.lm_params_to_numpy(tcfg, tp2)
    moments = jax.tree_util.tree_leaves(
        want_mu, is_leaf=lambda x: isinstance(x, dict) and "m" in x)
    for (path, w), g, mo in zip(
            jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(np.asarray, jp2)),
            _leaves(new), moments):
        err = np.abs(g - w)
        assert float(err.max()) <= 2.01 * LR, path
        sure = np.abs(mo["m"]) >= 1e-3 * np.abs(mo["m"]).max()
        assert float(err[sure].max(initial=0.0)) <= 1e-3 * LR, path
    # the caller's parameters are unchanged
    for a, b in zip(_leaves(convert.lm_params_to_numpy(tcfg, tp)),
                    _leaves(tree)):
        assert_bitwise_equal(a, b)


def test_accumulated_gradient_is_the_microbatch_mean():
    """``grad_accum = 2``: the step equals AdamW on the mean of the two
    microbatches' ``make_grad_step`` gradients (f32 sums in order, then
    the division), bit for bit, and its loss is their mean."""
    cfg = lm_pair("rwkv6-7b")[1].replace(grad_accum=2)
    params = tt.init_params(cfg, 2, device="cpu")
    _, tb = lm_batch(cfg, 12, 4, 16)
    oc = ta.OptConfig(schedule="const", warmup_steps=1)
    state = ta.adamw_init(params, oc)
    p2, s2, m = tsteps.make_train_step(cfg, TLOCAL, oc)(params, state, tb)
    gstep = tsteps.make_grad_step(cfg, TLOCAL)
    micro = tsteps._stack_micro(tb, 2)
    outs = [gstep(params, {k: v[i] for k, v in micro.items()})
            for i in range(2)]
    two = torch.tensor(2.0)
    mean = jax.tree_util.tree_map(
        lambda a, b: (torch.zeros(a.shape) + a.float() + b.float()) / two,
        outs[0][0], outs[1][0])
    q2, t2, n = ta.adamw_update(params, mean, state, oc)
    assert torch.equal(m["loss"], (outs[0][1] + outs[1][1]) / two)
    assert torch.equal(m["grad_norm"], n["grad_norm"])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves((p2, s2)), tree_leaves((q2, t2))))


def test_grad_step_leaves_the_parameters_alone():
    """No gradient is stored on, and no flag set on, the caller's tensors;
    gradients have the parameters' structure and dtypes (bf16 here)."""
    cfg = lm_pair("qwen3-0.6b")[1].replace(param_dtype="bfloat16",
                                           dtype="bfloat16")
    params = tt.init_params(cfg, 1, device="cpu")
    before = [t.clone() for t in tree_leaves(params)]
    _, tb = lm_batch(cfg, 13, 2, 16)
    grads, loss, metrics = tsteps.make_grad_step(cfg, TLOCAL)(params, tb)
    assert not loss.requires_grad and set(metrics) == {"nll", "aux"}
    for p, b, g in zip(tree_leaves(params), before, tree_leaves(grads)):
        assert not p.requires_grad and p.grad is None
        assert torch.equal(p, b)
        assert g.shape == p.shape and g.dtype == p.dtype


def test_stack_micro_moves_the_mrope_batch_axis():
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, 9, (6, 5))),
             "mrope_positions": torch.tensor(rng.integers(0, 9, (3, 6, 5)))}
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    got = tsteps._stack_micro(batch, 3)
    want = jsteps._stack_micro(jb, 3)
    assert got["mrope_positions"].shape == (3, 3, 2, 5)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_prefill_and_decode_steps_are_the_model_functions():
    cfg = lm_pair("qwen3-0.6b")[1]
    params = tt.init_params(cfg, 0, device="cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab,
                                                          (2, 9)))
    with torch.no_grad():
        logits, cache = tsteps.make_prefill_step(cfg, TLOCAL)(params,
                                                      {"tokens": toks})
        want, _ = tt.prefill(cfg, params, {"tokens": toks})
        assert torch.equal(logits, want)
        from repro_torch.serving import pad_attn_cache
        cache = pad_attn_cache(cache, 1)
        step, _ = tsteps.make_decode_step(cfg, TLOCAL)(params, cache,
                                                       toks[:, -1], 9)
        assert step.shape == (2, 1, cfg.vocab)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(arch, dtype):
    """JAX tree → the port's layers → JAX's layout, bit for bit with every
    dtype and the stacked structure kept (a bf16 tree keeps Mamba's f32
    leaves f32)."""
    from repro.configs import reduced_config as j_reduced
    from repro.models import transformer as jt
    from repro_torch.configs import reduced_config as t_reduced
    jcfg = j_reduced(arch).replace(param_dtype=dtype)
    tcfg = t_reduced(arch).replace(param_dtype=dtype)
    tree = jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(3)))
    back = convert.lm_params_to_numpy(
        tcfg, convert.lm_params_from_numpy(tcfg, tree, device="cpu"))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for (path, w), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            _leaves(back)):
        assert_bitwise_equal(b, w, jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="layers"):
        convert.lm_params_to_numpy(tcfg.replace(n_layers=tcfg.n_layers + 1),
                                   convert.lm_params_from_numpy(
                                       tcfg, tree, device="cpu"))
