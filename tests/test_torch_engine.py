"""Parity of the port's engine slice (``repro_torch.core.engine`` with
``rounding`` and ``centralized``) with the JAX package: the whole
``CapacityEngine.solve`` under the default, sweep and fused configurations.

Tolerances: fractional allocations and totals are held to 64 ULPs of their
scale (sums over classes reordered through a few Alg. 4.1 iterations, and a
120-step bisection whose comparisons read such sums); Algorithm 4.2's
integer r, slots and admissions are exact, as are prices, iteration counts
and feasibility flags.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal, assert_ulp_close
from _torch_parity import (RAGGED_NS, batch_pair, np_, scenario_pairs,
                           to_port_batch)
from repro.core import centralized as jc
from repro.core import engine as je
from repro.core import rounding as jr
from repro.core.sharding import lane_mesh
from repro.kernels.gnep_iter.ops import make_fused_iter_fn as j_iter
from repro.kernels.gnep_sweep.ops import make_batched_sweep_fn as j_sweep
from repro.kernels.gnep_sweep.ops import make_sweep_fn as j_sweep1
from repro_torch.core import centralized as tc
from repro_torch.core import engine as te
from repro_torch.core import rounding as tr
from repro_torch.core.sharding import lane_mesh as te_lane_mesh
from repro_torch.kernels.gnep_iter.ops import make_fused_iter_fn as t_iter
from repro_torch.kernels.gnep_sweep.ops import make_batched_sweep_fn as t_sweep
from repro_torch.kernels.gnep_sweep.ops import make_sweep_fn as t_sweep1

CONFIGS = {
    "default": ({}, {}),
    "sweep": ({"sweep_fn": j_sweep()}, {"sweep_fn": t_sweep()}),
    "fused": ({"iter_fn": j_iter(force_pallas=True)}, {"iter_fn": t_iter()}),
}


def engines(name, **common):
    kj, kt = CONFIGS[name]
    return (je.CapacityEngine(je.SolverConfig(**kj, **common)),
            te.CapacityEngine(te.SolverConfig(**kt, **common), device="cpu"))


def assert_integer_equal(got, want):
    for fld in ("r", "sM", "sR", "h"):
        np.testing.assert_array_equal(np_(getattr(got, fld)),
                                      np_(getattr(want, fld)), err_msg=fld)
    for fld in ("psi", "cost", "penalty", "total"):
        assert_ulp_close(np_(getattr(got, fld)), np_(getattr(want, fld)),
                         ulps=64, err_msg=fld)


def test_fingerprints_match_jax():
    jmesh, tmesh = lane_mesh(2), te_lane_mesh(devices=["cpu"] * 2)
    table = [
        ({}, {}),
        ({"eps_bar": 0.1, "lam": 0.2, "max_iters": 50},) * 2,
        ({"dtype": "float32"}, {"dtype": torch.float32}),
        ({"dtype": "float64"}, {"dtype": "float64"}),
        ({"sweep_fn": j_sweep()}, {"sweep_fn": t_sweep()}),
        ({"sweep_fn": j_sweep1()}, {"sweep_fn": t_sweep1()}),
        ({"iter_fn": j_iter()}, {"iter_fn": t_iter()}),
        ({"mesh": jmesh}, {"mesh": tmesh}),
        ({"iter_fn": j_iter(), "dtype_policy": "f32_checked[:2]"},
         {"iter_fn": t_iter(), "dtype_policy": "f32_checked[:2]"}),
        ({"dtype_policy": "f64"},) * 2,
    ]
    for kj, kt in table:
        want = je.SolverConfig(**kj).fingerprint()
        assert te.SolverConfig(**kt).fingerprint() == want


def test_dtype_policy_grammar_matches_jax():
    for policy in ("f64", "f32_checked", "f32_checked[:3]"):
        cj, ct = je.SolverConfig(dtype_policy=policy), te.SolverConfig(
            dtype_policy=policy)
        assert ct.check_sample() == cj.check_sample()
        assert str(ct.effective_dtype()).removeprefix("torch.") == str(
            np.dtype(cj.effective_dtype()))
    for bad in ("f16", "f32_checked[:0]", "f32_checked:2"):
        with pytest.raises(ValueError, match="unknown dtype_policy"):
            te.SolverConfig(dtype_policy=bad)
    with pytest.raises(ValueError, match="mutually exclusive"):
        te.SolverConfig(dtype="float32", dtype_policy="f64")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_batch_solve_matches_jax(name):
    """The whole slice — Alg. 4.1, Alg. 4.2 rounding and the report — under
    each configuration, on ragged padded lanes."""
    bj, bt = batch_pair(7)
    ej, et = engines(name)
    want, got = ej.solve(bj), et.solve(bt)
    np.testing.assert_array_equal(np_(got.iters), np_(want.iters))
    np.testing.assert_array_equal(np_(got.feasible), np_(want.feasible))
    for fld in ("r", "psi", "sM", "sR"):
        assert_ulp_close(np_(getattr(got.fractional, fld)),
                         np_(getattr(want.fractional, fld)), ulps=64,
                         scale=np_(want.fractional.r), err_msg=fld)
    assert_bitwise_equal(np_(got.fractional.aux), np_(want.fractional.aux))
    assert_integer_equal(got.integer, want.integer)
    assert np_(got.converged).tolist() == np_(want.converged).tolist()
    one_j, one_t = want.instance(2), got.instance(2)
    assert one_t.iters == one_j.iters
    np.testing.assert_array_equal(np_(one_t.r), np_(one_j.r))


@pytest.mark.parametrize("method", ["distributed", "centralized",
                                    "distributed-python"])
def test_engine_single_instance_matches_jax(method):
    sj, st = scenario_pairs(8, ns=(13,))
    want = je.CapacityEngine().solve(sj[0], method=method)
    got = te.CapacityEngine(device="cpu").solve(st[0], method=method)
    assert got.iters == want.iters and got.method == method
    assert_ulp_close(np_(got.fractional.r), np_(want.fractional.r), ulps=64,
                     scale=np_(want.fractional.r))
    assert_integer_equal(got.integer, want.integer)


def test_engine_coerces_scenario_lists_like_jax():
    sj, st = scenario_pairs(9)
    want = je.CapacityEngine().solve(sj)
    got = te.CapacityEngine(device="cpu").solve(st)
    np.testing.assert_array_equal(np_(got.mask), np_(want.mask))
    assert_integer_equal(got.integer, want.integer)
    with pytest.raises(TypeError, match="Scenario"):
        te.CapacityEngine(device="cpu").solve([1, 2])
    with pytest.raises(ValueError, match="method"):
        te.CapacityEngine(device="cpu").solve(st, method="centralized")


def test_infeasible_lanes_are_named():
    """Lanes whose capacity is below their guaranteed minimum are named by
    InfeasibleError, or flagged as JAX flags them."""
    bj, _ = batch_pair(10)
    R = np.array(bj.scenarios.R)
    R[[1, 3]] = 1.0
    bj = dataclasses.replace(bj, scenarios=bj.scenarios.replace(R=R))
    bt = to_port_batch(bj)
    with pytest.raises(te.InfeasibleError, match=r"\[1, 3\]"):
        te.CapacityEngine(device="cpu").solve(bt)
    got = te.CapacityEngine(device="cpu").solve(bt, check_feasible=False)
    want = je.CapacityEngine().solve(bj, check_feasible=False)
    np.testing.assert_array_equal(np_(got.feasible), np_(want.feasible))
    sj, st = scenario_pairs(11, ns=(6,), capacity_factor=0.01)
    with pytest.raises(te.InfeasibleError, match="infeasible"):
        te.CapacityEngine(device="cpu").solve(st[0])


def test_f32_checked_policy_matches_jax():
    bj, bt = batch_pair(12)
    cfg = {"dtype_policy": "f32_checked[:2]"}
    want = je.CapacityEngine(je.SolverConfig(**cfg)).solve(bj)
    got = te.CapacityEngine(te.SolverConfig(**cfg), device="cpu").solve(bt)
    assert got.fractional.r.dtype == torch.float32
    assert got.dtype_check["lanes"] == want.dtype_check["lanes"]
    assert got.dtype_check["max_rel"] <= got.dtype_check["bound"]
    np.testing.assert_array_equal(np_(got.iters), np_(want.iters))


def test_residency_is_not_ported_yet():
    """Residency and meshes are ported (the name predates them): a resident
    config is validated as the reference validates it, and a batch solve on
    a mesh matches JAX's on its mesh."""
    with pytest.raises(ValueError, match="needs a mesh"):
        te.CapacityEngine(te.SolverConfig(residency="resident"),
                          device="cpu")
    with pytest.raises(ValueError, match="residency"):
        te.CapacityEngine(te.SolverConfig(residency="x"), device="cpu")
    tmesh = te_lane_mesh(devices=["cpu"] * 2)
    eng = te.CapacityEngine(te.SolverConfig(mesh=tmesh, residency="resident"),
                            device="cpu")
    assert eng.config.fingerprint().endswith("residency=resident")
    bj, bt = batch_pair(0)
    got = te.CapacityEngine(te.SolverConfig(mesh=tmesh),
                            device="cpu").solve(bt)
    want = je.CapacityEngine(je.SolverConfig(mesh=lane_mesh(2))).solve(bj)
    np.testing.assert_array_equal(np_(got.iters), np_(want.iters))
    assert_bitwise_equal(np_(got.fractional.aux), np_(want.fractional.aux))
    assert_integer_equal(got.integer, want.integer)


def test_round_solution_batch_matches_jax():
    """Algorithm 4.2 on the same fractional input (JAX's equilibrium handed
    over through numpy): exact integers."""
    bj, bt = batch_pair(13, capacity_factor=0.85)
    sol = je.CapacityEngine(policies=je.Policies(
        rounding=je.RoundingPolicy(False))).solve(bj).fractional
    ins = [np.array(x) for x in (sol.r, sol.sM, sol.sR, sol.psi)]
    want = jr.round_solution_batch(bj, *ins)
    got = tr.round_solution_batch(bt, *map(torch.as_tensor, ins))
    assert_integer_equal(got, want)
    got_nopsi = tr.round_solution_batch(bt, *map(torch.as_tensor, ins[:3]))
    assert_integer_equal(got_nopsi, jr.round_solution_batch(bj, *ins[:3]))
    b = 1
    n = RAGGED_NS[b]
    one = [x[b, :n] for x in ins]
    assert_integer_equal(tr.round_solution(bt.instance(b),
                                           *map(torch.as_tensor, one)),
                         jr.round_solution(bj.instance(b), *one))


def test_centralized_matches_jax():
    bj, bt = batch_pair(14, capacity_factor=0.8)
    want, got = jc.solve_centralized_batch(bj), tc.solve_centralized_batch(bt)
    np.testing.assert_array_equal(np_(got.feasible), np_(want.feasible))
    for fld in ("r", "psi", "sM", "sR"):
        assert_ulp_close(np_(getattr(got, fld)), np_(getattr(want, fld)),
                         ulps=64, scale=np_(want.r), err_msg=fld)
    assert_ulp_close(np_(got.aux), np_(want.aux), ulps=64,
                     scale=np_(want.aux))
    assert_ulp_close(np_(got.total), np_(want.total), ulps=64,
                     scale=np_(want.total))
    b, n = 1, RAGGED_NS[1]
    one_t = tc.solve_centralized(bt.instance(b))
    assert float(tc.kkt_residual(bt.instance(b), one_t.r, one_t.aux)) < 1e-9
    assert_ulp_close(np_(tc.objective_of_r(bt.instance(b), one_t.r)),
                     np_(jc.objective_of_r(bj.instance(b),
                                           np.array(one_t.r))),
                     ulps=8)
    assert_ulp_close(np_(one_t.r), np_(want.r)[b, :n], ulps=64,
                     scale=np_(want.r))
