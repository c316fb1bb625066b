"""Hand state across between numpy and the port's containers.

The scenario data and the warm-start state play the part weights play in a
model: the tests turn a JAX ``Scenario`` / ``ScenarioBatch`` /
``BatchWarmStart`` into numpy arrays and build the port's counterpart from
them with these functions, so that both packages solve the same instance.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.game import BatchWarmStart
from repro_torch.core.types import Scenario, ScenarioBatch
from repro_torch.utils import resolve_device
from repro_torch.utils import to_np as to_numpy  # the other direction

__all__ = ["scenario_from_numpy", "batch_from_numpy", "warm_start_from_numpy",
           "to_numpy"]


def _tensor(x, dev, dtype):
    t = torch.tensor(np.asarray(x), device=dev)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def scenario_from_numpy(leaves: dict, *, device="cuda",
                        dtype=None) -> Scenario:
    """A :class:`Scenario` from a dict of its 22 fields as numpy arrays.

    Floating arrays are cast to ``dtype`` when given (kept otherwise); the
    tensors are placed on ``device`` (default the card).
    """
    dev = resolve_device(device)
    return Scenario(**{f.name: _tensor(leaves[f.name], dev, dtype)
                       for f in dataclasses.fields(Scenario)})


def batch_from_numpy(leaves: dict, mask, n_classes, *, device="cuda",
                     dtype=None) -> ScenarioBatch:
    """A :class:`ScenarioBatch` from stacked scenario fields, the (B, n_max)
    validity mask and the (B,) class counts."""
    dev = resolve_device(device)
    return ScenarioBatch(
        scenarios=scenario_from_numpy(leaves, device=dev, dtype=dtype),
        mask=_tensor(np.asarray(mask, dtype=bool), dev, None),
        n_classes=_tensor(np.asarray(n_classes, dtype=np.int64), dev, None))


def warm_start_from_numpy(leaves: dict, *, device="cuda",
                          dtype=None) -> BatchWarmStart:
    """A :class:`BatchWarmStart` from a dict of its five fields
    (``r``, ``bids``, ``rho``, ``lane_iters``, ``active``)."""
    dev = resolve_device(device)
    return BatchWarmStart(
        r=_tensor(leaves["r"], dev, dtype),
        bids=_tensor(leaves["bids"], dev, dtype),
        rho=_tensor(leaves["rho"], dev, dtype),
        lane_iters=_tensor(np.asarray(leaves["lane_iters"], dtype=np.int32),
                           dev, None),
        active=_tensor(np.asarray(leaves["active"], dtype=bool), dev, None))
