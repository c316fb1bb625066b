"""Parity of the port's Algorithm 4.1 (``repro_torch.core.game``) with the
JAX package on the same instances.

Tolerances: the CM best response and the bid update are elementwise, so
they are bitwise.  The RM solve and whole solves sum over classes (slack,
cumsum, objective) in an order each framework picks, so allocations are
held to 64 ULPs of the allocation scale and totals to 64 ULPs of the total;
prices, iteration counts and feasibility flags match exactly.
"""
import jax
import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal, assert_ulp_close
from _torch_parity import RAGGED_NS, batch_pair, leaves, np_, scenario_pair
from repro.core import game as jg
from repro_torch import convert
from repro_torch.core import game as tg
from repro_torch.core.sharding import LaneMesh, lane_mesh

SOLUTION_R = ("r", "psi", "sM", "sR")
SOLUTION_TOTALS = ("cost", "penalty", "total")


def assert_solution_close(got, want):
    np.testing.assert_array_equal(np_(got.iters), np_(want.iters))
    np.testing.assert_array_equal(np_(got.feasible), np_(want.feasible))
    for fld in SOLUTION_R:
        assert_ulp_close(np_(getattr(got, fld)), np_(getattr(want, fld)),
                         ulps=64, scale=np_(want.r), err_msg=fld)
    for fld in SOLUTION_TOTALS:
        assert_ulp_close(np_(getattr(got, fld)), np_(getattr(want, fld)),
                         ulps=64, scale=np_(want.total), err_msg=fld)
    assert_bitwise_equal(np_(got.aux), np_(want.aux), label="rho")


@pytest.mark.parametrize("masked", [False, True])
def test_rm_solve_matches_jax(masked):
    rng = np.random.default_rng(21)
    sj, st = scenario_pair(rng, 14, capacity_factor=0.85)
    bids = rng.uniform(float(sj.rho_bar), 20.0, 14)
    mask = rng.uniform(size=14) > 0.3 if masked else None
    kw_j = {"mask": mask} if masked else {}
    kw_t = {"mask": torch.as_tensor(mask)} if masked else {}
    rho_j, r_j, obj_j = jg.rm_solve(sj, bids, **kw_j)
    rho_t, r_t, obj_t = tg.rm_solve(st, torch.as_tensor(bids), **kw_t)
    assert float(rho_t) == float(rho_j)
    assert_ulp_close(np_(r_t), np_(r_j), ulps=64, scale=np_(r_j))
    assert_ulp_close(np_(obj_t), np_(obj_j), ulps=64,
                     scale=np.abs(np_(sj.p) * np_(sj.r_up)).sum())


@pytest.mark.parametrize("masked", [False, True])
def test_cm_best_response_and_bid_update_bitwise(masked):
    rng = np.random.default_rng(22)
    sj, st = scenario_pair(rng, 10)
    r = np.asarray(sj.r_low) * rng.uniform(0.5, 1.5, 10)
    mask = rng.uniform(size=10) > 0.3 if masked else None
    if masked:
        r = np.where(mask, r, 0.0)
    kw_j = {"mask": mask} if masked else {}
    kw_t = {"mask": torch.as_tensor(mask)} if masked else {}
    for got, want in zip(tg.cm_best_response(st, torch.as_tensor(r), **kw_t),
                         jg.cm_best_response(sj, r, **kw_j)):
        assert_bitwise_equal(np_(got), np_(want))
    psi = np.array(jg.cm_best_response(sj, r, **kw_j)[0])
    bids = rng.uniform(float(sj.rho_bar), 20.0, 10)
    rho = 3.75
    assert_bitwise_equal(
        np_(tg.cm_bid_update(st, torch.as_tensor(bids), torch.tensor(rho),
                             torch.as_tensor(psi), 0.05, **kw_t)),
        np_(jg.cm_bid_update(sj, bids, rho, psi, 0.05, **kw_j)))


@pytest.mark.parametrize("n", [6, 20])
def test_solve_distributed_matches_jax(n):
    sj, st = scenario_pair(np.random.default_rng(23 + n), n)
    assert_solution_close(tg.solve_distributed(st), jg.solve_distributed(sj))


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_distributed_batch_matches_jax(seed):
    """The default (plain, unfused) chain on ragged padded lanes."""
    bj, bt = batch_pair(seed)
    assert_solution_close(tg.solve_distributed_batch(bt),
                          jg.solve_distributed_batch(bj))


def test_batch_lanes_equal_single_instance_solves():
    """Padding is inert: each lane of the batched solve matches the
    single-instance solve of that lane's scenario."""
    _, bt = batch_pair(2)
    sol = tg.solve_distributed_batch(bt)
    for b, n in enumerate(RAGGED_NS):
        one = tg.solve_distributed(bt.instance(b))
        assert int(one.iters) == int(sol.iters[b])
        assert_ulp_close(np_(sol.r[b, :n]), np_(one.r), ulps=64,
                         scale=np_(one.r))
        assert np_(sol.r[b, n:]).tolist() == [0.0] * (sol.r.shape[1] - n)


def test_cold_start_matches_jax():
    bj, bt = batch_pair(3)
    for name, want in leaves(jg.cold_start(bj)).items():
        got = np_(getattr(tg.cold_start(bt), name))
        assert_bitwise_equal(got.astype(want.dtype), want, label=name)


def test_warm_start_frozen_lanes_match_jax():
    bj, bt = batch_pair(4)
    init = jg.cold_start(bj)
    frozen = np.array([True, False, False, True])
    init = init._replace(
        r=np.where(frozen[:, None], 2.5, np.asarray(init.r)),
        rho=np.where(frozen, 9.0, np.asarray(init.rho)),
        lane_iters=np.where(frozen, 5, 0).astype(np.int32),
        active=~frozen)
    want = jg.solve_distributed_batch(bj, init=jg.BatchWarmStart(*init))
    got = tg.solve_distributed_batch(
        bt, init=convert.warm_start_from_numpy(leaves(init), device="cpu"))
    assert_solution_close(got, want)
    assert_bitwise_equal(np_(got.r)[frozen], np.asarray(init.r)[frozen])
    np.testing.assert_array_equal(np_(got.aux)[frozen], 9.0)


def test_lane_eps_matches_jax():
    rng = np.random.default_rng(24)
    r_old = rng.uniform(0.0, 5.0, (3, 7)) * (rng.uniform(size=(3, 7)) > 0.2)
    r_new = r_old + rng.normal(size=(3, 7))
    mask = rng.uniform(size=(3, 7)) > 0.3
    want = jax.vmap(jg._lane_eps)(r_new, r_old, mask)
    got = tg._lane_eps(*map(torch.as_tensor, (r_new, r_old, mask)))
    assert_ulp_close(np_(got), np_(want), ulps=8)


def test_serial_baseline_matches_jax():
    sj, st = scenario_pair(np.random.default_rng(25), 12)
    sol_t, it_t, cm_t = tg.solve_distributed_python(st)
    sol_j, it_j, _ = jg.solve_distributed_python(sj)
    assert it_t == it_j == len(cm_t)
    assert_solution_close(sol_t, sol_j)
    assert sol_t.r.dtype == torch.float64


def test_mesh_is_not_ported_yet():
    """Meshes are ported (the name predates them): ``mesh=`` dispatches to
    the sharded solver, which equals the unsharded solve bit for bit and
    refuses a mesh that is not 1-D."""
    _, bt = batch_pair(0)
    mesh = lane_mesh(devices=["cpu"] * 3)
    got = tg.solve_distributed_batch(bt, mesh=mesh)
    want = tg.solve_distributed_batch(bt)
    for f in ("r", "psi", "aux", "total", "iters", "feasible"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="1-D mesh"):
        tg.solve_distributed_batch(
            bt, mesh=LaneMesh(mesh.devices.reshape(1, 3), ("a", "b")))
