"""Parity of the port's capacity planner and trace library with the JAX ones.

``repro_torch.core.traces`` is a copy of the numpy-only reference module
and is held to it bit for bit on the same seeds.  ``generate_grid`` draws
class parameters from a ``torch.Generator`` (equal to JAX's in
distribution only), so ``solve_plan`` is held to JAX on JAX's own
candidates carried across as numpy: iterations, feasibility and the
frontier queries exactly, cost / penalty / total / r within 64 ULPs of
their scale (``tests/_tolerance.py``; penalty's scale is its summands',
``sum |beta|``).  The JAX planner's own chunk-width bit-equality fails on
this jax (ROADMAP Queue 3 caveats), so the port's chunk-width invariance
and warm-equals-cold are held bit for bit among the port's runs.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal, assert_ulp_close
from _torch_parity import leaves
from repro.core import planning as jp
from repro.core import traces as jtr
from repro_torch import convert
from repro_torch.core import lane_mesh
from repro_torch.core import planning as tp
from repro_torch.core import traces as ttr
from repro_torch.core.engine import SolverConfig
from repro_torch.kernels.gnep_iter.ops import make_fused_iter_fn
from repro_torch.kernels.gnep_sweep.ops import make_batched_sweep_fn
from repro_torch.launch import plan as plan_cli
from repro_torch.serving import allocd as tallocd

AXES = dict(profile="bursty", rate=50.0, trace_events=256,
            cluster_sizes=(2000.0, 16000.0, 128000.0),
            deadline_scales=(0.7, 1.0, 1.4), penalty_scales=(1.0, 2.0),
            seed=3)
TIERS = (("small", 1.0, 6.0), ("large", 2.0, 10.0))
FIELDS = ("cost", "penalty", "total", "r", "iters", "feasible")
CONFIGS = {"default": SolverConfig(),
           "fused": SolverConfig(iter_fn=make_fused_iter_fn()),
           "sweep": SolverConfig(sweep_fn=make_batched_sweep_fn())}
ODD_N = 37      # an odd class count: every chunk's rows at another offset


def spec_pair(n_classes, **kw):
    """(JAX PlanSpec, port PlanSpec) over the same axes."""
    axes = dict(AXES, n_classes=n_classes, **kw)
    return (jp.PlanSpec(vm_tiers=tuple(jp.VMTier(*t) for t in TIERS),
                        **axes),
            tp.PlanSpec(vm_tiers=tuple(tp.VMTier(*t) for t in TIERS),
                        **axes))


def port_candidates(jgrid):
    """JAX candidates handed to the port as numpy, on the CPU."""
    return [tp.Candidate(c.index, dict(c.coords),
                         convert.scenario_from_numpy(leaves(c.scenario),
                                                     device="cpu"))
            for c in jgrid]


@pytest.fixture(scope="module")
def jax_plan():
    jspec, _ = spec_pair(12)
    grid = jp.generate_grid(jspec)
    return grid, jp.solve_plan(grid, chunk=8)


def assert_reports_bitwise(got, want):
    for k in FIELDS:
        assert_bitwise_equal(np.asarray(getattr(got, k)),
                             np.asarray(getattr(want, k)), label=k)


# --------------------------------------------------------------------------
# Traces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("profile", sorted(jtr.ARRIVAL_PROFILES))
def test_trace_generators_bitwise_to_jax(profile, seed):
    got = ttr.ARRIVAL_PROFILES[profile](seed, 300, 40.0)
    want = jtr.ARRIVAL_PROFILES[profile](seed, 300, 40.0)
    assert_bitwise_equal(got, want, label=profile)


def test_trace_library_shape_and_reexports():
    assert set(ttr.ARRIVAL_PROFILES) == set(jtr.ARRIVAL_PROFILES)
    assert tallocd.ARRIVAL_PROFILES is ttr.ARRIVAL_PROFILES
    for name in ("poisson_times", "flash_crowd_times", "diurnal_times",
                 "bursty_times", "straggler_times"):
        assert getattr(tallocd, name) is getattr(ttr, name)
    with pytest.raises(ValueError, match="tail_index"):
        ttr.straggler_times(0, 16, 10.0, tail_index=1.0)


# --------------------------------------------------------------------------
# Grid generation
# --------------------------------------------------------------------------

def test_grid_order_count_and_h_low_rule():
    jspec, tspec = spec_pair(5)
    grid = tp.generate_grid(tspec, device="cpu")
    assert len(grid) == tspec.n_candidates == jspec.n_candidates == 36
    assert tspec.grid_shape == jspec.grid_shape
    jgrid = jp.generate_grid(jspec)
    assert [c.coords for c in grid] == [c.coords for c in jgrid]
    assert [c.index for c in grid] == list(range(len(grid)))
    assert_bitwise_equal(tp._trace_weights(tspec), jp._trace_weights(jspec))
    for c in grid:
        s = c.scenario
        assert s.A.device.type == "cpu" and s.A.dtype == torch.float64
        h_up = s.H_up.numpy()
        assert np.all(h_up >= 1.0) and np.all(h_up == np.round(h_up))
        np.testing.assert_array_equal(
            s.H_low.numpy(), np.maximum(np.floor(0.8 * h_up), 1.0))
        assert float(s.R) == c.coords["cluster_size"]
        tier = dict((t[0], t) for t in TIERS)[c.coords["tier"]]
        assert float(s.rho_bar) == tier[2]


def test_grid_shares_draws_across_deadline_scales():
    _, tspec = spec_pair(6)
    grid = tp.generate_grid(tspec, device="cpu")
    again = tp.generate_grid(tspec, device="cpu")
    D = len(tspec.deadline_scales)
    for a, b in zip(grid, again):
        for f in dataclasses.fields(a.scenario):
            assert torch.equal(getattr(a.scenario, f.name),
                               getattr(b.scenario, f.name))
    for start in range(0, len(grid), D):
        chain = grid[start:start + D]
        for c in chain[1:]:
            for f in ("A", "B", "cM", "cR", "H_up", "H_low", "m", "rho_up"):
                assert torch.equal(getattr(c.scenario, f),
                                   getattr(chain[0].scenario, f)), f
            assert not torch.equal(c.scenario.E, chain[0].scenario.E)
    other = tp.generate_grid(dataclasses.replace(tspec, seed=4),
                             device="cpu")
    assert not torch.equal(other[0].scenario.A, grid[0].scenario.A)


def test_grid_validation():
    _, tspec = spec_pair(3)
    for bad in (dict(profile="nope"), dict(n_classes=0),
                dict(trace_events=0)):
        with pytest.raises(ValueError):
            tp.generate_grid(dataclasses.replace(tspec, **bad), device="cpu")
    assert tp.generate_grid(dataclasses.replace(tspec, cluster_sizes=()),
                            device="cpu") == []


# --------------------------------------------------------------------------
# solve_plan against JAX, on JAX's candidates
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_solve_plan_matches_jax_on_its_candidates(jax_plan, name):
    jgrid, want = jax_plan
    got = tp.solve_plan(port_candidates(jgrid), config=CONFIGS[name],
                        chunk=8, device="cpu")
    assert got.n_candidates == want.n_candidates and got.n_chunks == 5
    np.testing.assert_array_equal(got.iters, want.iters)
    np.testing.assert_array_equal(got.feasible, want.feasible)
    beta = max(float(np.abs(np.asarray(c.scenario.beta)).sum())
               for c in jgrid)
    for k in ("cost", "total", "r"):
        assert_ulp_close(getattr(got, k), getattr(want, k), ulps=64,
                         err_msg=k)
    assert_ulp_close(got.penalty, want.penalty, ulps=64,
                     scale=np.asarray(beta), err_msg="penalty")
    np.testing.assert_array_equal(got.pareto_frontier(),
                                  want.pareto_frontier())
    assert got.cheapest_feasible() == want.cheapest_feasible()
    budget = float(np.median(want.penalty))
    assert (got.cheapest_feasible(max_penalty=budget)
            == want.cheapest_feasible(max_penalty=budget))


def test_to_json_has_the_reference_keys(jax_plan):
    jgrid, want = jax_plan
    got = tp.solve_plan(port_candidates(jgrid), chunk=8, device="cpu")
    a, b = got.to_json(), want.to_json()
    assert set(a) == set(b)
    assert a["solver_config"] == b["solver_config"]
    assert [set(p) for p in a["frontier"]] == [set(p) for p in b["frontier"]]
    assert set(a["cheapest_feasible"]) == set(b["cheapest_feasible"])
    json.dumps(a)


def test_solve_plan_rejects_bad_args_and_empty_space():
    _, tspec = spec_pair(3)
    with pytest.raises(ValueError, match="chunk"):
        tp.solve_plan(tspec, chunk=0, device="cpu")
    grid = tp.generate_grid(tspec, device="cpu")
    with pytest.raises(ValueError, match="PlanSpec"):
        tp.solve_plan(grid, warm_start=True, device="cpu")
    empty = tp.solve_plan(dataclasses.replace(tspec, vm_tiers=()),
                          device="cpu")
    assert empty.n_candidates == 0 and empty.n_chunks == 0
    assert empty.pareto_frontier().size == 0
    assert empty.cheapest_feasible() is None


# --------------------------------------------------------------------------
# The port's own contract, bit for bit among its runs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fused", "sweep"])
@pytest.mark.parametrize("n_classes", [12, ODD_N])
def test_chunk_width_is_invisible_bitwise(n_classes, name):
    _, tspec = spec_pair(n_classes)
    grid = tp.generate_grid(tspec, device="cpu")
    cfg = CONFIGS[name]
    one = tp.solve_plan(grid, config=cfg, chunk=len(grid), device="cpu")
    assert one.n_chunks == 1
    for chunk in (5, 8, 13):
        assert_reports_bitwise(
            tp.solve_plan(grid, config=cfg, chunk=chunk, device="cpu"), one)
    sharded = dataclasses.replace(cfg, mesh=lane_mesh(devices=["cpu"] * 3))
    assert_reports_bitwise(
        tp.solve_plan(grid, config=sharded, chunk=8, device="cpu"), one)


@pytest.mark.parametrize("n_classes", [12, ODD_N])
def test_warm_start_matches_cold_bitwise(n_classes):
    _, tspec = spec_pair(n_classes)
    cold = tp.solve_plan(tspec, chunk=7, device="cpu")
    warm = tp.solve_plan(tspec, chunk=4, warm_start=True, device="cpu")
    assert warm.warm_start and warm.n_candidates == cold.n_candidates
    np.testing.assert_array_equal(warm.feasible, cold.feasible)
    same = warm.iters == cold.iters
    assert same[::len(tspec.deadline_scales)].all()
    for k in ("cost", "penalty", "total", "r"):
        assert_bitwise_equal(getattr(warm, k)[same], getattr(cold, k)[same],
                             label=k)
    scale = np.maximum(np.abs(cold.r), 1.0)
    rel = np.max(np.abs(warm.r - cold.r) / scale, axis=-1)
    assert np.all(rel[~same] <= 2 * SolverConfig().eps_bar)


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--shard", "--devices", "2"],
                                   ["--warm-start", "--chunk", "4"]])
def test_launch_plan_main_on_the_cpu(extra, tmp_path, capsys):
    out = tmp_path / "plan.json"
    report = plan_cli.main(["--device", "cpu", "--classes", "4",
                            "--profile", "bursty", "--json", str(out)]
                           + extra)
    text = capsys.readouterr().out
    assert "[plan] 18 candidates" in text and "Pareto frontier" in text
    payload = json.loads(out.read_text())
    assert payload["n_candidates"] == report.n_candidates == 18
    assert ("|mesh=2:lanes" in payload["solver_config"]) == ("--shard"
                                                             in extra)
    baseline = plan_cli.main(["--device", "cpu", "--classes", "4",
                              "--profile", "bursty"])
    capsys.readouterr()
    if "--warm-start" not in extra:
        assert_reports_bitwise(report, baseline)
