"""The port's training launcher (``repro_torch.launch.train``) and its
checkpoint layout (``convert.lm_params_{to,from}_host``,
``convert.opt_state_{to,from}_host``), against the JAX package's
``repro.launch.train``.

Reduced Qwen3-0.6B (f32), B 4 x T 32 in 2 microbatches, 4 steps, a
checkpoint every 2.  A port run resumed from its own ``step_2`` gives the
uninterrupted run's losses and ``step_4`` files bit for bit.  Across the
packages the weights are drawn differently, so each direction resumes
from the other package's ``step_2``: the losses are held within 1e-5
relative (``tests/test_torch_steps.py::test_train_step_matches_jax``'s
tolerance for a step's loss) and every leaf of the final checkpoint within
``GRAD_RTOL`` of its largest |value| (the step counter exactly).
"""
import hashlib
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _tolerance import assert_bitwise_equal
from _torch_lm import GRAD_RTOL, LOSS_RTOL
from repro.launch import train as jtrain
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, reduced_config
from repro_torch.launch import train as ttrain
from repro_torch.models import init_params
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.utils import tree_leaves

ARGS = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "4",
        "--global-batch", "4", "--seq", "32", "--grad-accum", "2",
        "--ckpt-every", "2", "--log-every", "1"]


def _port(ckpt_dir):
    return ttrain.main(ARGS + ["--ckpt-dir", str(ckpt_dir),
                               "--device", "cpu"])


def _jax(ckpt_dir):
    return jtrain.main(ARGS + ["--ckpt-dir", str(ckpt_dir)])


def _resume_dir(src, dst):
    """``dst`` holding only ``src``'s ``step_2``."""
    shutil.copytree(Path(src) / "step_2", Path(dst) / "step_2")
    return dst


def _digests(step_dir):
    return {p.name: hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(Path(step_dir).iterdir())}


def _leaves(step_dir):
    manifest = json.loads((Path(step_dir) / "manifest.json").read_text())
    return {path: np.load(Path(step_dir) / info["file"])
            for path, info in manifest["leaves"].items()}


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Uninterrupted runs of both launchers: (port dir, port losses, JAX
    dir, JAX losses)."""
    root = tmp_path_factory.mktemp("train")
    torch.use_deterministic_algorithms(True)
    try:
        port = _port(root / "port")
    finally:
        torch.use_deterministic_algorithms(False)
    return root / "port", port, root / "jax", _jax(root / "jax")


def test_uninterrupted_run_keeps_two_checkpoints(runs):
    port_dir, losses, _, jax_losses = runs
    assert len(losses) == len(jax_losses) == 4
    assert all(np.isfinite(losses))
    assert sorted(p.name for p in port_dir.iterdir()) == ["step_2",
                                                          "step_4"]
    manifest = json.loads((port_dir / "step_4" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 4
    assert manifest["leaves"]["opt/step"]["dtype"] == "int32"
    assert int(_leaves(port_dir / "step_4")["opt/step"]) == 4


def test_resume_is_bit_for_bit(runs, tmp_path, deterministic, capsys):
    port_dir, losses, _, _ = runs
    got = _port(_resume_dir(port_dir, tmp_path))
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert got == losses[2:]
    assert _digests(tmp_path / "step_4") == _digests(port_dir / "step_4")


def _close_checkpoints(got_dir, want_dir):
    got, want = _leaves(got_dir), _leaves(want_dir)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=path)
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= GRAD_RTOL * scale, f"{path}: {err} > {GRAD_RTOL} x {scale}"


def test_port_resumes_a_jax_run(runs, tmp_path):
    _, _, jax_dir, jax_losses = runs
    got = _port(_resume_dir(jax_dir, tmp_path))
    np.testing.assert_allclose(got, jax_losses[2:], rtol=LOSS_RTOL)
    _close_checkpoints(tmp_path / "step_4", jax_dir / "step_4")


def test_jax_resumes_a_port_run(runs, tmp_path, capsys):
    port_dir, losses, _, _ = runs
    got = _jax(_resume_dir(port_dir, tmp_path))
    assert "[train] resumed from step 2" in capsys.readouterr().out
    np.testing.assert_allclose(got, losses[2:], rtol=LOSS_RTOL)
    _close_checkpoints(tmp_path / "step_4", port_dir / "step_4")


def test_mesh_run_is_the_single_device_run(runs, tmp_path, deterministic):
    """``--mesh 2,2 --device cpu`` (the CPU device repeated over a (2, 2)
    mesh): a dense model's losses and step 4 files are the mesh-less
    run's bit for bit."""
    port_dir, losses, _, _ = runs
    got = ttrain.main(ARGS + ["--mesh", "2,2", "--device", "cpu",
                              "--ckpt-dir", str(tmp_path)])
    assert got == losses
    assert _digests(tmp_path / "step_4") == _digests(port_dir / "step_4")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(ARGS)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype,tier", [("float32", "f32"),
                                        ("bfloat16", "bf16"),
                                        ("bfloat16", "int8")])
def test_host_layout_is_the_numpy_layout(arch, dtype, tier):
    """The checkpoint layout of parameters and AdamW state: bit for bit
    ``lm_params_to_numpy`` / ``opt_state_to_numpy`` (bf16 leaves by their
    bits), sharing no memory with the port's tensors, and back to them bit
    for bit."""
    cfg = reduced_config(arch).replace(param_dtype=dtype)
    params = init_params(cfg, 5, device="cpu")
    opt = adamw_init(params, OptConfig(state_dtype=tier))
    host = {"params": convert.lm_params_to_host(cfg, params),
            "opt": convert.opt_state_to_host(cfg, opt)}
    want = {"params": convert.lm_params_to_numpy(cfg, params),
            "opt": convert.opt_state_to_numpy(cfg, opt)}
    assert (jax.tree_util.tree_structure(host)
            == jax.tree_util.tree_structure(want))
    for h, w in zip(jax.tree_util.tree_leaves(host),
                    jax.tree_util.tree_leaves(want)):
        assert h.device.type == "cpu"
        got = (h.view(torch.int16).numpy().view(w.dtype)
               if h.dtype == torch.bfloat16 else h.numpy())
        assert_bitwise_equal(got, w)
    ptrs = {t.untyped_storage().data_ptr() for t in tree_leaves(host)}
    assert not ptrs & {t.untyped_storage().data_ptr()
                       for t in tree_leaves((params, opt))}
    p2 = convert.lm_params_from_host(cfg, host["params"], device="cpu")
    o2 = convert.opt_state_from_host(cfg, host["opt"], device="cpu")
    for a, b in zip(tree_leaves((p2, o2)), tree_leaves((params, opt))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
