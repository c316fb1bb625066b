"""Hand state across between numpy and the port's containers.

The scenario data and the warm-start state play the part weights play in a
model: the tests turn a JAX ``Scenario`` / ``ScenarioBatch`` /
``BatchWarmStart`` / ``WindowState`` into numpy arrays and build the port's
counterpart from them with these functions, so that both packages solve the
same instance.  Stream events cross as plain records of Python scalars
(``event_from_record``).  ``lm_params_from_numpy`` does the same for the
language models' weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.game import BatchWarmStart
from repro_torch.core.types import (CapacityChange, ClassArrival,
                                    ClassDeparture, Scenario, ScenarioBatch,
                                    SLAEdit, StreamEvent, WindowState)
from repro_torch.utils import resolve_device
from repro_torch.utils import to_np as to_numpy  # the other direction

__all__ = ["scenario_from_numpy", "batch_from_numpy", "warm_start_from_numpy",
           "window_state_from_numpy", "event_from_record",
           "lm_params_from_numpy", "to_numpy"]


def _tensor(x, dev, dtype):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: no numpy type
        t = torch.tensor(x.astype(np.float32), device=dev).to(torch.bfloat16)
    else:
        t = torch.tensor(x, device=dev)
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


def window_state_from_numpy(leaves: dict, *, device="cuda",
                            dtype=None) -> WindowState:
    """A :class:`WindowState` from a dict of its four fields (``r``,
    ``rho``, ``lane_iters``, ``solved``): a window's last equilibrium."""
    dev = resolve_device(device)
    return WindowState(
        r=_tensor(leaves["r"], dev, dtype),
        rho=_tensor(leaves["rho"], dev, dtype),
        lane_iters=_tensor(np.asarray(leaves["lane_iters"], dtype=np.int32),
                           dev, None),
        solved=_tensor(np.asarray(leaves["solved"], dtype=bool), dev, None))


_EVENTS = {cls.__name__: cls for cls in (ClassArrival, ClassDeparture,
                                         SLAEdit, CapacityChange)}


def event_from_record(record: dict) -> StreamEvent:
    """The port's stream event from a plain record of one.

    ``record["kind"]`` names the event class (``"ClassArrival"``,
    ``"ClassDeparture"``, ``"SLAEdit"`` or ``"CapacityChange"``); the other
    keys are its fields: ``lane``, and ``params``, ``slot``, ``updates`` or
    ``R`` as Python scalars (dicts of them for ``params`` / ``updates``).
    """
    fields = dict(record)
    kind = fields.pop("kind")
    if kind not in _EVENTS:
        raise ValueError(f"unknown event kind {kind!r}; expected one of "
                         f"{sorted(_EVENTS)}")
    for key in ("params", "updates"):
        if key in fields:
            fields[key] = {k: float(v) for k, v in fields[key].items()}
    for key in ("lane", "slot"):
        if key in fields:
            fields[key] = int(fields[key])
    if "R" in fields:
        fields["R"] = float(fields["R"])
    return _EVENTS[kind](**fields)


def lm_params_from_numpy(cfg, tree: dict, *, device="cuda", dtype=None):
    """The port's model parameters from a JAX ``init_params`` pytree given
    as nested dicts of numpy arrays.

    ``params["layers"]`` takes the MoE families' ``tree["head_layers"]``
    (the ``first_k_dense`` layers, a list) first, then the leading
    ``n_blocks`` axis of ``tree["blocks"]`` unstacked block by block and,
    inside a block, layer by layer (``l0``, ``l1``, ...; Jamba's eight).
    The encoder-decoder's ``tree["enc_blocks"]`` / ``tree["dec_blocks"]``
    (one layer a block) become ``params["enc_layers"]`` and
    ``params["layers"]``, and ``enc_final_norm`` crosses as it is.  Expert
    stacks ``(E, d, f)`` keep their shape.  Floating arrays are cast to
    ``dtype`` when given; left as None, a bf16 tree keeps its f32 leaves
    (Mamba's ``A_log``, ``D``, ``dt_bias``) in f32.
    """
    dev = resolve_device(device)

    def conv(sub, index=None):
        if isinstance(sub, dict):
            return {k: conv(v, index) for k, v in sub.items()}
        return _tensor(sub if index is None else np.asarray(sub)[index], dev,
                       dtype)

    def unstack(blocks, block_len):
        n_blocks = len(np.asarray(blocks["l0"]["norm1"]["gamma"]))
        return [conv(blocks[f"l{p}"], i) for i in range(n_blocks)
                for p in range(block_len)]

    params = {k: conv(tree[k]) for k in ("embed", "pos_embed", "final_norm",
                                         "enc_final_norm", "unembed_w")
              if k in tree}
    if cfg.is_encdec:
        params["enc_layers"] = unstack(tree["enc_blocks"], 1)
        params["layers"] = unstack(tree["dec_blocks"], 1)
    else:
        params["layers"] = [conv(layer)
                            for layer in tree.get("head_layers", [])]
        params["layers"] += unstack(tree["blocks"], cfg.block_len)
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params['layers'])} layers in the tree, "
                         f"{cfg.n_layers} in {cfg.name}")
    return params
