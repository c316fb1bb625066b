"""Parity of the port's dry-run inputs (``repro_torch.configs.specs`` and
the meta construction of parameters, optimizer state and caches) with
``repro.configs.specs`` and JAX's ``eval_shape``.

* ``cell_is_live`` and ``live_cells``: equal to JAX's, 32 live cells of 40.
* ``input_specs``: every arch x shape, the meta tensors' shapes and dtypes
  equal to the ``ShapeDtypeStruct``s (the decode cache restacked into
  JAX's ``head`` / ``blocks`` layout).
* ``init_params(cfg, None, device="meta")`` at full size: every leaf's
  shape and dtype equal to ``jax.eval_shape(init_params)``'s under
  ``convert``'s layout; nothing is drawn.  ``adamw_init`` on meta in every
  state tier has the CPU state's shapes and dtypes.
"""
import jax
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import specs as jspecs
from repro.models import init_params as j_init_params
from repro.models.config import ALL_SHAPES as J_SHAPES
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, ARCHS, get_config, reduced_config
from repro_torch.configs import specs as tspecs
from repro_torch.models import init_params
from repro_torch.models.config import ALL_SHAPES
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.utils import tree_leaves


def _sd(x):
    """(shape, dtype name) of a tensor or a ShapeDtypeStruct."""
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _jax_tree(tree):
    return jax.tree_util.tree_map(_sd, tree)


def _stack(ts):
    return ((len(ts),) + tuple(ts[0].shape),
            str(ts[0].dtype).replace("torch.", ""))


def _cache_layout(cfg, cache):
    """The port's per-layer cache restacked as JAX's ``init_cache``:
    ``{"head": [...], "blocks": {"l0": ..., ...}}``."""
    layers = cache["layers"]
    first = cfg.moe.first_k_dense if (cfg.moe and not cfg.is_encdec) else 0
    bl = 1 if cfg.is_encdec else cfg.block_len

    def restack(xs):
        if isinstance(xs[0], dict):
            return {k: restack([x[k] for x in xs]) for k in xs[0]}
        return _stack(xs)

    leaf = lambda t: _sd(t)  # noqa: E731
    return {"head": [jax.tree_util.tree_map(leaf, x, is_leaf=torch.is_tensor)
                     for x in layers[:first]],
            "blocks": {f"l{p}": restack(layers[first + p::bl])
                       for p in range(bl)}}


def test_live_cells_match_jax():
    cells = tspecs.live_cells(ARCHS, ALL_SHAPES)
    assert cells == jspecs.live_cells(J_ARCHS, J_SHAPES)
    assert len(cells) == 32
    for aid in ARCH_IDS:
        for s, js in zip(ALL_SHAPES, J_SHAPES):
            assert tspecs.cell_is_live(get_config(aid), s) == \
                jspecs.cell_is_live(j_get_config(aid), js)
    assert tspecs.SUBQUADRATIC == jspecs.SUBQUADRATIC


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_meta_params_match_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for s, js in zip(ALL_SHAPES, J_SHAPES):
        got = tspecs.input_specs(cfg, s)
        want = jspecs.input_specs(jcfg, js)
        assert all(t.is_meta for t in tree_leaves(got))
        if s.kind == "decode":
            assert _sd(got["token"]) == _sd(want["token"])
            assert _sd(got["pos"]) == _sd(want["pos"])
            assert _cache_layout(cfg, got["cache"]) == _jax_tree(
                want["cache"]), s.name
        else:
            assert {k: _sd(v) for k, v in got["batch"].items()} == \
                _jax_tree(want["batch"]), s.name

    state = torch.random.get_rng_state()
    params = init_params(cfg, None, device="meta")
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(t.is_meta for t in tree_leaves(params))
    got = convert._to_jax_layout(cfg, params, _sd, _stack)
    want = _jax_tree(jax.eval_shape(
        lambda: j_init_params(jcfg, jax.random.PRNGKey(0))))
    assert got == want


def test_meta_params_take_no_generator():
    with pytest.raises(ValueError, match="draw nothing"):
        init_params(get_config("qwen3-0.6b"), 0, device="meta")


@pytest.mark.parametrize("tier", ["f32", "bf16", "int8"])
def test_meta_optimizer_state_has_the_cpu_states_shapes(tier):
    cfg = reduced_config("qwen3-0.6b")
    oc = OptConfig(state_dtype=tier)
    meta = adamw_init(init_params(cfg, None, device="meta"), oc)
    cpu = adamw_init(init_params(cfg, 0, device="cpu"), oc)
    assert all(t.is_meta for t in tree_leaves(meta))
    assert [_sd(t) for t in tree_leaves(meta)] == \
        [_sd(t) for t in tree_leaves(cpu)]
