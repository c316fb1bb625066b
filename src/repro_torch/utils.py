"""Small shared helpers of the PyTorch port (counterpart of ``repro.utils``)."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List

import numpy as np
import torch


def fdtype() -> torch.dtype:
    """Canonical float dtype: float64, as the JAX reference runs with x64."""
    return torch.float64


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there.

    Entry points default to ``"cuda"``; on a host without a card they raise
    here instead of carrying on on the CPU.  Pass ``device="cpu"`` to run on
    the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def indexed_device(device) -> torch.device:
    """:func:`resolve_device` with a CUDA device's index filled in (the
    current device where none is given), so that equal devices compare
    equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tree_map(fn, obj):
    """Apply ``fn`` to every tensor inside dataclasses, NamedTuples, dicts,
    lists and tuples (the port's stand-in for ``jax.tree_util.tree_map``)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return type(obj)(**{f.name: tree_map(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(tree_map(fn, x) for x in obj))
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_map(fn, x) for x in obj)
    return obj


def to_np(tree: Any) -> Any:
    """Copy every tensor of ``tree`` to a numpy array (structure kept)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Every tensor of ``tree``, in :func:`tree_map`'s order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        kids = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        kids = list(tree.values())
    elif isinstance(tree, (list, tuple)):
        kids = list(tree)
    else:
        return []
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_bytes(tree: Any) -> int:
    """Bytes held by the tensors of ``tree``."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tree_params(tree: Any) -> int:
    """Number of values held by the tensors of ``tree``."""
    return sum(t.numel() for t in tree_leaves(tree))


def block_until_ready(tree: Any) -> Any:
    """Wait for the work queued on every CUDA device that a tensor of
    ``tree`` lies on (nothing to wait for on the CPU); returns ``tree``."""
    for dev in {t.device for t in tree_leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def time_fn(fn: Callable[[], Any], *, warmup: int = 1, iters: int = 5) -> float:
    """Median wall-clock seconds a call (waits for each call's tensors)."""
    for _ in range(warmup):
        block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))
