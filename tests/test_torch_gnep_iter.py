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


# --------------------------------------------------------------------------
# The premises of the CUDA kernel's design, on the plain version: what it
# skips changes no bit, and what it must not skip is pinned.
# --------------------------------------------------------------------------


def _middle_operands(seed, steps, zero_class=None):
    """The JAX prep's operand bits after ``steps`` reference iterations, as
    numpy; ``zero_class = (lane, column)`` gives that real class zero fill
    headroom (r_up == r_low), inside the lane's live columns."""
    bj, _ = batch_pair(seed)
    args = [np.array(a) for a in jax_middle_inputs(bj, steps)]
    if zero_class is not None:
        args[1][zero_class] = 0.0
    return args


def _live(inc_max, p):
    """Per lane, one past the last column that can change an accumulator:
    every column but those with zero headroom and a finite penalty rate."""
    live = ~((inc_max == 0) & np.isfinite(p))
    cols = np.arange(1, inc_max.shape[1] + 1)
    return np.where(live, cols, 0).max(axis=1)


def _plain(args):
    return tk.fused_iter_sweep(*(torch.as_tensor(a) for a in args))


def _assert_matches_jax(args, got):
    """The JAX Pallas kernel (interpret mode) on the same operand bits, as
    ``test_plain_middle_matches_jax_kernel`` holds it: the winner exact,
    the objective and the winning fill row within 4 ULPs."""
    import jax.numpy as jnp
    f_j, o_j, b_j, r_j = j_fused(*(jnp.asarray(a) for a in args),
                                 block_c=7, block_n=5, interpret=True)
    f_t, o_t, b_t, r_t = got
    np.testing.assert_array_equal(np_(b_t), np_(b_j), err_msg="best")
    assert_bitwise_equal(np_(r_t), np_(r_j), label="rho")
    scale = np.abs(args[8])[:, None]
    assert_ulp_close(np_(o_t), np_(o_j), ulps=4, scale=scale, err_msg="obj")
    win = np_(f_j)[np.arange(len(b_j)), np_(b_j)]
    assert_ulp_close(np_(f_t), win, ulps=4, scale=args[4], err_msg="fill")


@pytest.mark.parametrize("steps", [0, 3])
def test_truncating_to_live_columns_changes_no_bit(steps):
    """Each lane cut to its live columns gives the same obj, best and rho
    bit for bit, and the full replay's fill past them is +0.  Lane 1 has a
    real zero-headroom class inside its live range, which stays walked."""
    args = _middle_operands(0, steps, zero_class=(1, 2))
    L = _live(args[1], args[2])
    n_max = args[0].shape[1]
    assert L[1] > 3 and (L < n_max).any()
    fill, obj, best, rho = _plain(args)
    for b in range(len(L)):
        cut = [a[b:b + 1, :L[b]] for a in args[:3]] + \
              [a[b:b + 1] for a in args[3:]]
        f_b, o_b, b_b, r_b = _plain(cut)
        assert_bitwise_equal(np_(o_b)[0], np_(obj)[b], label=f"obj {b}")
        assert int(b_b[0]) == int(best[b])
        assert_bitwise_equal(np_(r_b)[0], np_(rho)[b], label=f"rho {b}")
        assert_bitwise_equal(np_(f_b)[0], np_(fill)[b, :L[b]],
                             label=f"fill {b}")
        tail = np_(fill)[b, L[b]:]
        assert_bitwise_equal(tail, np.zeros_like(tail), label=f"tail {b}")


def test_live_column_operands_match_jax_kernel():
    args = _middle_operands(0, 3, zero_class=(1, 2))
    _assert_matches_jax(args, _plain(args))


def _with_duplicates(args):
    """The candidates with copies of column N (rho_bar) in front and of
    columns N and N + 1 (rho_bar, rho_hat) behind: equal bits, new
    indices.  Returns the operands and the source column of each."""
    n = args[0].shape[1]
    src = np.concatenate([[n], np.arange(n + 2), [n, n + 1]])
    dup = list(args)
    dup[3] = np.ascontiguousarray(args[3][:, src])
    return dup, src


@pytest.mark.parametrize("steps", [0, 3])
def test_equal_candidate_bits_share_the_objective(steps):
    """Every copy of a candidate gets its objective bit for bit; where the
    rho_bar group wins, best is the group's smallest index."""
    args = _middle_operands(1, steps)
    _, obj, _, rho = _plain(args)
    dup, src = _with_duplicates(args)
    _, obj_d, best_d, rho_d = _plain(dup)
    assert_bitwise_equal(np_(obj_d), np_(obj)[:, src], label="obj copies")
    assert_bitwise_equal(np_(rho_d), np_(rho), label="rho")
    rb_bits = args[5].view(np.int64)[:, None]
    in_group = dup[3].view(np.int64) == rb_bits
    won = np_(rho_d).view(np.int64) == args[5].view(np.int64)
    assert won.any()
    np.testing.assert_array_equal(np_(best_d)[won],
                                  in_group.argmax(axis=1)[won])
    np.testing.assert_array_equal(np_(best_d)[won], 0)


def test_duplicated_candidates_match_jax_kernel():
    dup, _ = _with_duplicates(_middle_operands(1, 3))
    _assert_matches_jax(dup, _plain(dup))


def test_tie_picks_the_first_candidate():
    """spare = sum_r_low = 0: no class fills, every objective is equal, and
    the first maximum is candidate 0 in every lane (also in JAX)."""
    args = _middle_operands(2, 3)
    args[4] = np.zeros_like(args[4])
    args[6] = np.zeros_like(args[6])
    got = _plain(args)
    obj = np_(got[1])
    np.testing.assert_array_equal(obj, np.repeat(obj[:, :1], obj.shape[1], 1))
    np.testing.assert_array_equal(np_(got[2]), 0)
    _assert_matches_jax(args, got)


def test_fill_can_follow_a_saturated_cum():
    """Why no walk stops when cum reaches spare: (cum + inc) - inc can lose
    the old cum, so a later column still fills.  spare = 1, increments
    (1, 2^60): cum is 1 = spare after column 0, yet column 1 fills 1."""
    one = torch.ones((1, 1), dtype=torch.float64)
    bids = torch.full((1, 2), 5.0, dtype=torch.float64)
    inc = torch.tensor([[1.0, 2.0 ** 60]], dtype=torch.float64)
    p = torch.ones((1, 2), dtype=torch.float64)
    z = torch.zeros(1, dtype=torch.float64)
    fill, _, best, _ = tk.fused_iter_sweep(bids, inc, p, one, one[0], z, z,
                                           z, z)
    assert int(best[0]) == 0
    assert_bitwise_equal(np_(fill), np.array([[1.0, 1.0]]))
