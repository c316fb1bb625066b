"""Parity of the port's fused Alg. 4.1 iteration (``repro_torch.kernels
.gnep_iter``) with the JAX package.

On the CPU the port's kernel wrapper runs its plain version,
``ref.fused_middle_reference``.  It is held to the JAX Pallas kernel run in
interpret mode on the very same operand bits (the JAX prep handed over
through numpy): the two run the same column recurrence in the same order,
so they agree to within 4 ULPs of the objective's scale (the slack is for
a multiply-add that XLA's CPU compiler may contract into one rounding; the
port never does), and the winning candidate is exact.  Where each package
computes its own prep (sums over N classes in its own order), one step is
held to 64 ULPs of the allocation scale, and whole solves likewise, with
iteration counts and feasibility flags exact.
"""
import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal, assert_ulp_close
from _torch_parity import batch_pair, leaves, np_
from repro.core import game as jg
from repro.kernels.gnep_iter import ref as jref
from repro.kernels.gnep_iter.kernel import fused_iter_sweep as j_fused
from repro.kernels.gnep_iter.ops import make_fused_iter_fn as j_make
from repro_torch.core import game as tg
from repro_torch import convert
from repro_torch.kernels.gnep_iter import kernel as tk
from repro_torch.kernels.gnep_iter import ref as tref
from repro_torch.kernels.gnep_iter.ops import FusedIterFn, make_fused_iter_fn

J_PALLAS = j_make(force_pallas=True)
PORT = make_fused_iter_fn()
PREP_FIELDS = ("inc_max_sorted", "p_sorted", "spare", "rho_bar", "sum_r_low",
               "p_r_low", "const")


def jax_middle_inputs(bj, steps):
    """JAX kernel-middle operands after ``steps`` reference iterations."""
    import jax.numpy as jnp
    scns, mask = bj.scenarios, bj.mask
    prep = jref.prepare(scns, mask)
    init = jg.cold_start(bj)
    r, bids = init.r, init.bids
    for _ in range(steps):
        r, _, bids, _ = jref.iter_step(prep, scns, mask, r, bids, 0.05)
    bids_eff = jnp.where(mask, bids, scns.rho_bar[:, None])
    cand = jnp.concatenate(
        [bids_eff, scns.rho_bar[:, None], scns.rho_hat[:, None]], axis=1)
    bids_sorted = jnp.take_along_axis(bids_eff, prep.order, axis=1)
    return (bids_sorted, prep.inc_max_sorted, prep.p_sorted, cand,
            prep.spare, prep.rho_bar, prep.sum_r_low, prep.p_r_low,
            prep.const)


@pytest.mark.parametrize("steps", [0, 3])
@pytest.mark.parametrize("bc,bn", [(128, 512), (7, 5), (1, 1)])
def test_plain_middle_matches_jax_kernel(bc, bn, steps):
    bj, _ = batch_pair(0)
    args = jax_middle_inputs(bj, steps)
    f_j, o_j, b_j, r_j = j_fused(*args, block_c=bc, block_n=bn,
                                 interpret=True)
    f_t, o_t, b_t, r_t = tk.fused_iter_sweep(
        *(torch.as_tensor(np.array(a)) for a in args))
    np.testing.assert_array_equal(np_(b_t), np_(b_j), err_msg="best")
    assert_bitwise_equal(np_(r_t), np_(r_j), label="rho")
    scale = np.abs(np_(args[8]))[:, None]           # const: objective scale
    assert_ulp_close(np_(o_t), np_(o_j), ulps=4, scale=scale, err_msg="obj")
    win = np_(f_j)[np.arange(len(b_j)), np_(b_j)]
    assert_ulp_close(np_(f_t), win, ulps=4, scale=np_(args[4]),
                     err_msg="fill_best")


def test_middle_reference_rows_are_the_fused_middle():
    """The full-fill middle (the JAX kernel's outputs) and the fused middle
    (the CUDA kernel's) agree bit for bit on the winning row."""
    _, bt = batch_pair(1)
    prep = tref.prepare(bt.scenarios, bt.mask)
    bids = bt.scenarios.rho_up.clone()
    _, cand = tref.candidates(bt.scenarios, bt.mask, bids)
    bids_sorted = torch.gather(torch.where(bt.mask, bids,
                                           bt.scenarios.rho_bar[:, None]),
                               1, prep.order)
    fill, obj, best, rho = tref.middle_reference(prep, cand, bids_sorted)
    f2, o2, b2, r2 = tref.fused_middle_reference(
        bids_sorted, *(getattr(prep, k) for k in ("inc_max_sorted",
                                                  "p_sorted")),
        cand, *(getattr(prep, k) for k in PREP_FIELDS[2:]))
    assert torch.equal(best, b2) and torch.equal(rho, r2)
    assert_bitwise_equal(np_(o2), np_(obj), label="obj")
    assert_bitwise_equal(np_(f2), np_(fill[torch.arange(len(best)), best]),
                         label="fill row")


def test_prepare_matches_jax():
    bj, bt = batch_pair(2)
    pj = jref.prepare(bj.scenarios, bj.mask)
    pt = tref.prepare(bt.scenarios, bt.mask)
    for name in ("order", "inv"):
        np.testing.assert_array_equal(np_(getattr(pt, name)),
                                      np_(getattr(pj, name)), err_msg=name)
    for name in ("inc_max_sorted", "p_sorted", "r_low_eff", "rho_bar"):
        assert_bitwise_equal(np_(getattr(pt, name)), np_(getattr(pj, name)),
                             label=name)
    for name in ("spare", "sum_r_low", "p_r_low", "const"):
        assert_ulp_close(np_(getattr(pt, name)), np_(getattr(pj, name)),
                         ulps=16, err_msg=name)


def test_iter_step_matches_jax_pallas_step():
    """Four fused steps fed back their own state: the port's plain middle
    against the JAX step with the Pallas middle (interpret mode)."""
    bj, bt = batch_pair(3)
    pj = J_PALLAS.prepare(bj.scenarios, bj.mask)
    pt = PORT.prepare(bt.scenarios, bt.mask)
    ij, it = jg.cold_start(bj), tg.cold_start(bt)
    rj, bidj, rt, bidt = ij.r, ij.bids, it.r, it.bids
    for _ in range(4):
        rj, rhoj, bidj, epsj = J_PALLAS.step(pj, bj.scenarios, bj.mask, rj,
                                             bidj, 0.05)
        rt, rhot, bidt, epst = PORT.step(pt, bt.scenarios, bt.mask, rt, bidt,
                                         0.05)
        assert_bitwise_equal(np_(rhot), np_(rhoj), label="rho")
        assert_bitwise_equal(np_(bidt), np_(bidj), label="bids")
        assert_ulp_close(np_(rt), np_(rj), ulps=64, scale=np_(rj),
                         err_msg="r")
        assert_ulp_close(np_(epst), np_(epsj), ulps=64, scale=np_(epsj),
                         err_msg="eps")


@pytest.mark.parametrize("eps_bar,max_iters", [(0.03, 200), (0.0, 12)])
def test_fused_solve_matches_jax(eps_bar, max_iters):
    """Whole fused solves, converged and pinned (eps_bar = 0, where the
    rejecting class managers raise their bids at every step)."""
    bj, bt = batch_pair(4)
    want = jg.solve_distributed_batch(bj, eps_bar=eps_bar,
                                      max_iters=max_iters, iter_fn=J_PALLAS)
    got = tg.solve_distributed_batch(bt, eps_bar=eps_bar,
                                     max_iters=max_iters, iter_fn=PORT)
    np.testing.assert_array_equal(np_(got.iters), np_(want.iters))
    np.testing.assert_array_equal(np_(got.feasible), np_(want.feasible))
    for fld in ("r", "psi", "sM", "sR"):
        assert_ulp_close(np_(getattr(got, fld)), np_(getattr(want, fld)),
                         ulps=64, scale=np_(want.r), err_msg=fld)
    for fld in ("cost", "penalty", "total"):
        assert_ulp_close(np_(getattr(got, fld)), np_(getattr(want, fld)),
                         ulps=64, scale=np_(want.total), err_msg=fld)
    assert_bitwise_equal(np_(got.aux), np_(want.aux), label="rho")


def test_fused_warm_start_frozen_lanes_match_jax():
    """A JAX warm start (two frozen lanes with sentinel state) handed over
    through numpy: frozen lanes pass through bit for bit, active lanes
    converge as JAX's do."""
    bj, bt = batch_pair(5)
    init = jg.cold_start(bj)
    frozen = np.array([False, True, False, True])
    init = init._replace(
        r=np.where(frozen[:, None], 7.25, np.asarray(init.r)),
        rho=np.where(frozen, 3.5, np.asarray(init.rho)),
        lane_iters=np.where(frozen, 11, 0).astype(np.int32),
        active=~frozen)
    want = jg.solve_distributed_batch(bj, init=jg.BatchWarmStart(*init),
                                      iter_fn=J_PALLAS)
    got = tg.solve_distributed_batch(
        bt, init=convert.warm_start_from_numpy(leaves(init), device="cpu"),
        iter_fn=PORT)
    np.testing.assert_array_equal(np_(got.iters), np_(want.iters))
    np.testing.assert_array_equal(np_(got.iters)[frozen], 11)
    assert_bitwise_equal(np_(got.r)[frozen], np.asarray(init.r)[frozen])
    assert_ulp_close(np_(got.r), np_(want.r), ulps=64, scale=np_(want.r))


def test_fused_wrapper_takes_the_plain_version_only_on_cpu():
    _, bt = batch_pair(6)
    prep = tref.prepare(bt.scenarios, bt.mask)
    bids_eff, cand = tref.candidates(bt.scenarios, bt.mask,
                                     bt.scenarios.rho_up.clone())
    args = (torch.gather(bids_eff, 1, prep.order), prep.inc_max_sorted,
            prep.p_sorted, cand, *(getattr(prep, k) for k in PREP_FIELDS[2:]))
    before = tk.fused_iter_sweep.launches
    for got, want in zip(tk.fused_iter_sweep(*args),
                         tref.fused_middle_reference(*args)):
        assert_bitwise_equal(np_(got), np_(want))
    assert tk.fused_iter_sweep.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tk.fused_iter_sweep(*(a.to("meta") for a in args))


def test_fused_iter_fn_is_memoized_and_named_as_in_jax():
    assert make_fused_iter_fn() is PORT
    assert PORT.__name__ == j_make().__name__
    assert FusedIterFn("x").__name__ == "x"
