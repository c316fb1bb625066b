"""Small shared helpers of the PyTorch port (counterpart of ``repro.utils``)."""
from __future__ import annotations

import dataclasses
from typing import Any

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
