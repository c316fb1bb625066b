"""Parity of the port's small helpers with the JAX package:
``profiles.from_roofline`` (the six sqrt-derived fields within 16 ULPs,
ROADMAP Queue 3 item 4, the rest bit for bit), the paper's
``game.distributed_walltime_estimate`` (equal), and ``utils.tree_bytes`` /
``tree_params`` (equal on trees handed across through numpy); ``time_fn``
and ``block_until_ready`` on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal
from _torch_parity import batch_pair, leaves, np_, to_port_batch
from repro import utils as ju
from repro.core import game as jg
from repro.core import profiles as jp
from repro_torch import utils as tu
from repro_torch.core import game as tg
from repro_torch.core import profiles as tp
from repro_torch.core import types as tt

SQRT_DERIVED = ("xiM", "xiR", "K", "r_up", "r_low", "p")


@pytest.mark.parametrize("n", [1, 6])
def test_from_roofline_matches_jax(n):
    rng = np.random.default_rng(90 + n)
    args = (rng.uniform(0.5, 5.0, n), rng.uniform(0.1, 2.0, n),
            rng.uniform(0.01, 0.2, n), rng.uniform(20.0, 60.0, n))
    kw = dict(chips_ref=8.0, H_up=rng.integers(5, 21, n).astype(float),
              H_low=rng.integers(1, 5, n).astype(float),
              m=rng.uniform(1e4, 3e4, n), rho_up=rng.uniform(5.0, 20.0, n),
              R=64.0, rho_bar=1.3)
    want = jp.from_roofline(*args, **kw)
    got = tp.from_roofline(*args, **kw, device="cpu")
    assert got.A.dtype == torch.float64 and got.A.device.type == "cpu"
    for f in dataclasses.fields(tt.Scenario):
        g, w = np_(getattr(got, f.name)), np.asarray(getattr(want, f.name))
        if f.name in SQRT_DERIVED:
            np.testing.assert_allclose(g, w, rtol=16 * np.finfo(w.dtype).eps,
                                       atol=0, err_msg=f.name)
        else:
            assert_bitwise_equal(g, w, f.name)
    assert (np_(got.cM) == 1.0).all() and (np_(got.cR) == 1.0).all()


def test_from_roofline_follows_the_device_rule():
    kw = dict(chips_ref=4.0, H_up=10.0, H_low=2.0, m=1e4, rho_up=8.0, R=16.0)
    scn = tp.from_roofline(1.0, 1.0, 0.1, 30.0, **kw, device="cpu")
    assert scn.A.shape == () and scn.A.device.type == "cpu"
    if not torch.cuda.is_available():        # the card by default, no fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tp.from_roofline(1.0, 1.0, 0.1, 30.0, **kw)


def test_distributed_walltime_estimate_matches_jax():
    for args in [(12, 7, 0.35), (1, 1, 0.0), (0, 3, 1.0, 0.02),
                 (40, 25, 2.5, 0.1, 5e-4)]:
        assert tg.distributed_walltime_estimate(*args) == \
            jg.distributed_walltime_estimate(*args)


def test_tree_bytes_and_params_match_jax():
    bj, _ = batch_pair(91, (5, 9, 3))
    bt = to_port_batch(bj)
    init_j = jg.cold_start(bj)
    tree_j = {"batch": bj, "init": init_j, "extra": [bj.mask, bj.n_classes]}
    tree_t = {"batch": bt, "init": tg.cold_start(bt),
              "extra": [bt.mask, bt.n_classes]}
    assert tu.tree_bytes(tree_t) == ju.tree_bytes(tree_j)
    assert tu.tree_params(tree_t) == ju.tree_params(tree_j)
    assert len(tu.tree_leaves(tree_t)) == len(
        [x for x in leaves(bj.scenarios).values()]) + 2 + 5 + 2
    assert tu.tree_bytes(torch.zeros((3, 4), dtype=torch.float16)) == 24
    assert tu.tree_params(None) == 0 and tu.tree_leaves(3.0) == []


def test_time_fn_and_block_until_ready_on_the_cpu():
    x = torch.arange(1000, dtype=torch.float64)
    tree = {"a": x, "b": (x * 2,)}
    assert tu.block_until_ready(tree) is tree
    calls = []

    def fn():
        calls.append(1)
        return {"s": x.sum()}

    t = tu.time_fn(fn, warmup=2, iters=3)
    assert isinstance(t, float) and t > 0.0 and len(calls) == 5
