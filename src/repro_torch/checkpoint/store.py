"""Fault-tolerant checkpoints of tensor trees (counterpart of
``repro.checkpoint.store``, in its on-disk format).

Layout:  <dir>/step_<N>/manifest.json + <leaf-hash>.npy per tree leaf.
A leaf's path is its dict keys and list or tuple indices joined by ``/``
(dict keys in sorted order, as JAX flattens them), and its file is the
first 16 hex digits of the path's sha1.  Numpy dtypes are stored as they
are (``"stored": "native"``); bfloat16, which numpy lacks, as its raw bytes
(``"raw_u8"``, ``"dtype": "bfloat16"``).  So either package reads what the
other writes.  Writes go to a temp dir and are atomically renamed, so a
crash mid-save never corrupts the latest checkpoint.

``restore(..., shardings=...)`` places each leaf that has a sharding on its
mesh's first device, where the port's mesh layout keeps a sharded tensor
whole (``repro_torch.models.sharding``): re-meshing a run is a restore
onto another mesh's shardings.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

_PENDING: list = []


def _leaf_name(path_str: str) -> str:
    h = hashlib.sha1(path_str.encode()).hexdigest()[:16]
    return f"{h}.npy"


def _paths(tree, prefix=()):
    """[(path string, tensor)] in JAX's flattening order."""
    if isinstance(tree, torch.Tensor):
        return [("/".join(prefix), tree)]
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), x) for i, x in enumerate(tree))
    else:
        raise TypeError(f"checkpoint leaf {'/'.join(prefix)!r} is a "
                        f"{type(tree).__name__}, not a tensor")
    return [out for key, sub in items for out in _paths(sub, prefix + (key,))]


def _unflatten(tree, leaves):
    """``tree``'s structure with its tensors replaced, in :func:`_paths`'
    order, by the next of ``leaves`` (an iterator)."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    return type(tree)(_unflatten(x, leaves) for x in tree)


def _to_numpy(t: torch.Tensor):
    """(array to store, dtype name, stored kind) of one leaf."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        raw = np.atleast_1d(t.contiguous().view(torch.int16).numpy())
        return raw.view(np.uint8), "bfloat16", "raw_u8"
    arr = t.numpy()
    return arr, str(arr.dtype), "native"


def _from_numpy(arr: np.ndarray, info: dict) -> torch.Tensor:
    if info.get("stored") == "raw_u8":
        if info["dtype"] != "bfloat16":
            raise ValueError(f"raw leaf of dtype {info['dtype']!r}: only "
                             "bfloat16 is stored raw")
        bits = arr.view(np.int16).reshape(info["shape"])
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(tree: Any, step: int, ckpt_dir: str, *, keep_last: int = 3,
         extra: Optional[dict] = None) -> str:
    """Write ``tree`` (dicts, lists and tuples of tensors) as
    ``<ckpt_dir>/step_<step>``, then drop all but the newest ``keep_last``
    steps.  Returns the step's directory."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".tmp_step_{step}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for ps, leaf in _paths(tree):
        arr, dtype_name, stored = _to_numpy(leaf)
        fn = _leaf_name(ps)
        np.save(tmp / fn, arr)
        manifest["leaves"][ps] = {"file": fn, "shape": list(leaf.shape),
                                  "dtype": dtype_name, "stored": stored}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = d / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # atomic publish
    _gc(d, keep_last)
    return str(final)


class _Writer(threading.Thread):
    """A thread that runs :func:`save` and keeps its exception for
    :func:`wait_pending`."""

    def __init__(self, tree, step, ckpt_dir, kw):
        super().__init__(daemon=True)
        self.args, self.error = (tree, step, ckpt_dir, kw), None

    def run(self):
        tree, step, ckpt_dir, kw = self.args
        try:
            save(tree, step, ckpt_dir, **kw)
        except Exception as e:  # noqa: BLE001 -- re-raised by wait_pending
            self.error = e


def save_async(tree: Any, step: int, ckpt_dir: str,
               **kw) -> threading.Thread:
    """Snapshot to host memory synchronously (a copy of every leaf, so
    later in-place writes do not reach it), write to disk in a thread."""
    host = _unflatten(tree, iter([leaf.detach().to("cpu", copy=True)
                                  for _, leaf in _paths(tree)]))
    t = _Writer(host, step, ckpt_dir, kw)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    """Join every writer of :func:`save_async`; re-raise the first one's
    exception, so that a failed save does not pass for a saved one."""
    for t in _PENDING:
        t.join()
    errors = [t.error for t in _PENDING if t.error is not None]
    _PENDING.clear()
    if errors:
        raise errors[0]


def _gc(d: Path, keep_last: int):
    steps = sorted((int(p.name.split("_")[1]) for p in d.glob("step_*")),
                   reverse=True)
    for s in steps[keep_last:]:
        shutil.rmtree(d / f"step_{s}", ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step with a manifest (a step directory without one, or a
    leftover ``.tmp_step_*``, is not a checkpoint), or None."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _sharding_paths(tree, prefix=()):
    """{path: sharding} of a tree of shardings (dicts, lists and tuples;
    a None subtree gives no path), in :func:`_paths`' path form."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {"/".join(prefix): tree}
    return {path: sh for key, sub in items
            for path, sh in _sharding_paths(sub, prefix + (key,)).items()}


def restore(tree_like: Any, step: int, ckpt_dir: str, *, shardings=None):
    """Restore into the structure of ``tree_like``: each leaf in its stored
    dtype, on its sharding's device where ``shardings`` (a tree of
    ``NamedSharding``s of the same structure, or of None subtrees) gives
    one, else on the device of the matching leaf of ``tree_like`` (only the
    structure and the devices are read).  Under the port's mesh layout a
    sharding names only its mesh's first device; the argument is kept for
    the reference's signature, and where ``tree_like`` already lies on
    that device (as the launcher's does) it changes nothing.  Returns
    ``(tree, manifest)``."""
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    sh_map = _sharding_paths(shardings)
    leaves = []
    for ps, like in _paths(tree_like):
        info = manifest["leaves"][ps]
        arr = np.load(d / info["file"])
        sh = sh_map.get(ps)
        leaves.append(_from_numpy(arr, info).to(
            like.device if sh is None else sh.device))
    return _unflatten(tree_like, iter(leaves)), manifest


def manifest_extra(ckpt_dir: str, step: int) -> dict:
    d = Path(ckpt_dir) / f"step_{step}"
    return json.loads((d / "manifest.json").read_text()).get("extra", {})
