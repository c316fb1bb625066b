"""Parity of the port's containers, profiles and converters with the JAX
package, plus the port's import and device guards.

Tolerances: ``derive``, padding, stacking, ``take`` / ``instance`` and the
converters are elementwise or pure data movement, so they are held bitwise
at f64.  ``objective`` sums N terms in an order each framework picks, so it
is held to 4 ULPs of the total.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal, assert_ulp_close
from _torch_parity import (RAGGED_NS, batch_pair, leaves, np_, scenario_pair,
                           to_port_batch)
from repro.core import profiles as jprof
from repro.core import types as jt
from repro_torch import convert
from repro_torch.core import engine as te
from repro_torch.core import profiles as tprof
from repro_torch.core import types as tt

ROOT = Path(__file__).resolve().parents[1]
FIELDS = [f.name for f in dataclasses.fields(jt.Scenario)]


def assert_scenarios_bitwise(sj, st):
    for name in FIELDS:
        assert_bitwise_equal(np_(getattr(st, name)), np_(getattr(sj, name)),
                             label=name)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 24)])
def test_derive_bitwise(seed, n):
    """All 22 leaves of the derived Scenario, bit for bit."""
    sj, st = scenario_pair(np.random.default_rng(seed), n)
    assert_scenarios_bitwise(sj, st)
    assert st.n == sj.n == n


@pytest.mark.parametrize("n_max", [None, 16])
def test_pad_and_stack_bitwise(n_max):
    """Neutral padding, stacking, mask and class counts, bit for bit."""
    bj, bt = batch_pair(0, n_max=n_max)
    assert_scenarios_bitwise(bj.scenarios, bt.scenarios)
    np.testing.assert_array_equal(np_(bt.mask), np_(bj.mask))
    np.testing.assert_array_equal(np_(bt.n_classes), np_(bj.n_classes))
    assert (bt.batch_size, bt.n_max) == (bj.batch_size, bj.n_max)


def test_take_and_instance_bitwise():
    bj, bt = batch_pair(1)
    assert_scenarios_bitwise(bj.take([2, 0]).scenarios,
                             bt.take([2, 0]).scenarios)
    for b in range(len(RAGGED_NS)):
        assert_scenarios_bitwise(bj.instance(b), bt.instance(b))


def test_neutral_values_and_pad_guard():
    assert tt.neutral_class_values(1.25) == jt.neutral_class_values(1.25)
    assert tt.RAW_CLASS_FIELDS == jt.RAW_CLASS_FIELDS
    _, st = scenario_pair(np.random.default_rng(3), 6)
    with pytest.raises(ValueError, match="n_max=4"):
        tt.pad_scenario(st, 4)
    with pytest.raises(ValueError):
        tt.stack_scenarios([], device="cpu")


def test_objective_and_deadline_lhs():
    rng = np.random.default_rng(4)
    sj, st = scenario_pair(rng, 11)
    r = np.asarray(sj.r_low) + rng.uniform(0.0, 1.0, 11) * np.asarray(
        sj.r_up - sj.r_low)
    psi = rng.uniform(np.asarray(sj.psi_low), np.asarray(sj.psi_up))
    sM, sR = np.asarray(sj.xiM) * r, np.asarray(sj.xiR) * r
    tr = [torch.as_tensor(x) for x in (r, psi, sM, sR)]
    want = jt.objective(sj, jnp.asarray(r), jnp.asarray(psi))
    assert_ulp_close(np_(tt.objective(st, tr[0], tr[1])), np_(want), ulps=4)
    assert_bitwise_equal(np_(tt.deadline_lhs(st, *tr[1:])),
                         np_(jt.deadline_lhs(sj, *map(jnp.asarray,
                                                      (psi, sM, sR)))))


def test_sample_scenario_matches_table5_in_distribution():
    """The torch.Generator draws follow the reference's Table-5 design:
    the same ranges, and per-field means within 5 standard errors of the
    JAX sample's."""
    n = 3000
    st = tprof.sample_scenario(torch.Generator().manual_seed(0), n,
                               device="cpu")
    sj = jprof.sample_scenario(jax.random.PRNGKey(0), n)
    assert st.A.dtype == torch.float64
    for name in ("A", "B", "E", "cM", "cR", "H_up", "H_low", "m", "rho_up",
                 "K", "p"):
        a, b = np_(getattr(st, name)), np_(getattr(sj, name))
        span = b.max() - b.min()
        assert b.min() - 0.1 * span <= a.min() <= a.max() <= b.max() + 0.1 * span
        se = np.sqrt(a.var() / n + b.var() / n)
        assert abs(a.mean() - b.mean()) <= 5 * se + 1e-12, name
    for name in ("cM", "cR", "H_up", "H_low"):
        vals = np_(getattr(st, name))
        np.testing.assert_array_equal(vals, np.round(vals))
    assert set(np.unique(np_(st.cM))) == {1.0, 2.0, 3.0, 4.0}
    assert (np_(st.E) < 0).all()
    assert_ulp_close(np_(st.R), 1.1 * np_(st.r_up).sum(), ulps=4)
    assert 0.5 < float(st.rho_bar) < 2.0


def test_sample_scenario_seeded_and_placed():
    def draw(seed):
        return tprof.sample_scenario(torch.Generator().manual_seed(seed), 9,
                                     capacity_factor=0.95,
                                     dtype=torch.float32, device="cpu")
    a, b, c = draw(5), draw(5), draw(6)
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert not torch.equal(a.A, c.A)
    assert a.A.dtype == torch.float32 and a.A.device.type == "cpu"
    params = tprof.sample_class_params(torch.Generator().manual_seed(1))
    assert set(params) == set(tt.RAW_CLASS_FIELDS)
    assert all(isinstance(v, float) for v in params.values())
    assert params["E"] < 0 and 1 <= params["cM"] <= 4


def test_convert_round_trip_bitwise():
    """JAX batch -> numpy -> port batch -> numpy is the identity, and a JAX
    warm start crosses the same way."""
    from repro.core.game import cold_start as jcold
    bj, _ = batch_pair(2)
    bt = to_port_batch(bj)
    back = convert.to_numpy(bt)
    for name in FIELDS:
        assert_bitwise_equal(getattr(back.scenarios, name),
                             np_(getattr(bj.scenarios, name)), label=name)
    np.testing.assert_array_equal(back.mask, np_(bj.mask))
    ws = convert.warm_start_from_numpy(leaves(jcold(bj)), device="cpu")
    for name, arr in leaves(jcold(bj)).items():
        got = np_(getattr(ws, name))
        assert_bitwise_equal(got.astype(arr.dtype), arr, label=name)
    assert ws.active.dtype == torch.bool and ws.lane_iters.dtype == torch.int32


# --------------------------------------------------------------------------
# Guards: the port stands alone, and runs on the card unless asked otherwise
# --------------------------------------------------------------------------

def _port_modules():
    pkg = ROOT / "src" / "repro_torch"
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in pkg.rglob("*.py"))


def test_port_imports_neither_jax_nor_repro():
    """Importing every port module pulls in no ``jax`` and no ``repro``."""
    code = ("import sys\n"
            f"mods = {_port_modules()!r}\n"
            "for m in mods:\n"
            "    __import__(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib')) or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_port_sources_name_no_jax_or_repro_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (
                    f"{path.relative_to(ROOT)} imports {name}")


def test_default_device_is_the_card(monkeypatch):
    """Without CUDA, every input constructor refuses its default device,
    naming it, and works when asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    bj, bt = batch_pair(0)
    calls = [
        lambda **kw: tprof.sample_scenario(gen, 4, **kw),
        lambda **kw: tt.stack_scenarios([bt.instance(0)], **kw),
        lambda **kw: convert.batch_from_numpy(
            leaves(bj.scenarios), np_(bj.mask), np_(bj.n_classes), **kw),
        lambda **kw: te._coerce(bt, **kw),
        lambda **kw: te.CapacityEngine(**kw),
        lambda **kw: convert.window_state_from_numpy(
            {"r": np.zeros((1, 2)), "rho": np.ones(1),
             "lane_iters": np.zeros(1), "solved": np.ones(1)}, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
        call(device="cpu")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py fails without printing a result where CUDA is absent,
    both in the repository and alone in an empty directory."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, env=env, cwd=script.parent,
                             timeout=240)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
