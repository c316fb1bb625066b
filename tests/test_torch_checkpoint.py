"""The port's checkpoint store (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``), whose on-disk format it keeps.

A tree of dicts and lists with f32, int32, int8 and bf16 leaves written by
either package is read by the other with equal bits, dtypes and shapes (no
tolerance), and both write the same files byte for byte.  The rest holds
the store's own contract: garbage collection, what ``latest_step`` counts,
the copy that ``save_async`` snapshots and the errors ``wait_pending``
re-raises.
"""
import hashlib
import json
import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store as tstore


def _arrays(seed=0):
    """The numpy leaves of the mixed tree (bf16 as ml_dtypes')."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "f32": f32,
        "int32": rng.integers(-2**31, 2**31 - 1, (4,), dtype=np.int32),
        "int8": rng.integers(-128, 127, (2, 3, 4), dtype=np.int8),
        "bf16": rng.standard_normal((6, 7)).astype(ml_dtypes.bfloat16),
        "scalar": np.asarray(7, np.int32),
        "bf16_row": f32[0].astype(ml_dtypes.bfloat16),
    }


def _torch_leaf(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tree(leaf, a):
    """Dicts and lists, keys out of sorted order."""
    return {"zeta": leaf(a["f32"]),
            "blocks": [{"w": leaf(a["bf16"]), "q": leaf(a["int8"])},
                       {"w": leaf(a["bf16_row"]), "q": leaf(a["int32"])}],
            "alpha": {"step": leaf(a["scalar"])}}


def _pairs(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp), leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _bits(x):
    """(dtype name, shape, raw bytes) of a tensor or array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    else:
        x = np.asarray(x)
        name = str(x.dtype)
    return name, x.shape, np.ascontiguousarray(x).tobytes()


def _same_trees(got_pairs, want_pairs):
    assert [p for p, _ in got_pairs] == [p for p, _ in want_pairs]
    for (path, g), (_, w) in zip(got_pairs, want_pairs):
        assert _bits(g) == _bits(w), path


def _digest(d):
    return {p.name: hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(Path(d).iterdir())}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    """``tests/test_substrate.py::test_checkpoint_roundtrip_and_gc``, on
    the port's tensors."""
    tree = {"a": torch.arange(10.0),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}}
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        tstore.save(tree, s, d, keep_last=2)
    assert tstore.latest_step(d) == 5
    # GC kept only the last 2
    assert sorted(int(p.split("_")[1]) for p in os.listdir(d)) == [4, 5]
    out, manifest = tstore.restore(tree, 5, d)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert manifest["step"] == 5


def test_port_writes_what_jax_reads_and_the_same_files(tmp_path):
    a = _arrays(1)
    ttree = _tree(_torch_leaf, a)
    tstore.save(ttree, 3, tmp_path / "t", extra={"note": "port"})
    jtree = _tree(jnp.asarray, a)
    out, manifest = jstore.restore(jtree, 3, str(tmp_path / "t"))
    _same_trees(_pairs(out), _pairs(jtree))
    assert manifest["extra"] == {"note": "port"}
    assert jstore.manifest_extra(str(tmp_path / "t"), 3) == {"note": "port"}
    # the JAX package writes the same bytes, manifest included
    jstore.save(jtree, 3, str(tmp_path / "j"), extra={"note": "port"})
    assert (_digest(tmp_path / "t" / "step_3")
            == _digest(tmp_path / "j" / "step_3"))


def test_port_reads_what_jax_writes(tmp_path):
    a = _arrays(2)
    jtree = _tree(jnp.asarray, a)
    jstore.save(jtree, 8, str(tmp_path), extra={"k": 1})
    like = _tree(lambda x: torch.zeros(()), a)   # only paths are read
    out, manifest = tstore.restore(like, 8, str(tmp_path))
    _same_trees(_pairs(out), _pairs(jtree))
    assert isinstance(out["blocks"], list) and set(out) == set(like)
    assert manifest["step"] == 8
    assert tstore.manifest_extra(str(tmp_path), 8) == {"k": 1}
    info = json.loads((tmp_path / "step_8" / "manifest.json").read_text())
    assert info["leaves"]["blocks/0/w"] == {
        "file": tstore._leaf_name("blocks/0/w"), "shape": [6, 7],
        "dtype": "bfloat16", "stored": "raw_u8"}


def test_restore_lands_on_the_template_leaf_device(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    tstore.save(tree, 1, str(tmp_path))
    like = {"w": torch.empty(0, device="meta"), "b": torch.empty(0)}
    out, _ = tstore.restore(like, 1, str(tmp_path))
    assert out["w"].device.type == "meta" and out["w"].shape == (2, 3)
    assert out["b"].device.type == "cpu" and out["b"].dtype == torch.bfloat16
    assert torch.equal(out["b"], tree["b"])


def test_latest_step_skips_unfinished_saves(tmp_path):
    d = str(tmp_path)
    assert tstore.latest_step(d) is None
    assert tstore.latest_step(str(tmp_path / "absent")) is None
    tstore.save({"x": torch.ones(2)}, 2, d)
    (tmp_path / ".tmp_step_9_123").mkdir()          # a crashed save
    (tmp_path / "step_7").mkdir()                   # no manifest
    assert tstore.latest_step(d) == 2 == jstore.latest_step(d)


def test_save_async_snapshots_a_copy(tmp_path, monkeypatch):
    """The writer thread is held back until the caller has written into
    the saved tensor in place: the checkpoint still holds the old
    values."""
    written = threading.Event()
    save = tstore.save

    def held_save(*args, **kw):
        assert written.wait(timeout=30)
        return save(*args, **kw)
    monkeypatch.setattr(tstore, "save", held_save)
    x = torch.arange(100_000, dtype=torch.float32)
    before = x.clone()
    tstore.save_async({"x": x}, 1, str(tmp_path))
    x.add_(1.0)                           # an in-place step after the save
    written.set()
    tstore.wait_pending()
    out, _ = tstore.restore({"x": x}, 1, str(tmp_path))
    assert torch.equal(out["x"], before)


def test_wait_pending_reraises_a_writer_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    t = tstore.save_async({"x": torch.ones(2)}, 1, str(blocker / "ckpt"))
    with pytest.raises(OSError):
        tstore.wait_pending()
    assert not t.is_alive()
    tstore.wait_pending()                 # the failure is reported once
    assert tstore.latest_step(str(tmp_path)) is None


def test_non_tensor_leaf_raises(tmp_path):
    with pytest.raises(TypeError, match="a/0"):
        tstore.save({"a": [np.ones(2)]}, 1, str(tmp_path))
