"""Hand state across between numpy and the port's containers.

The scenario data and the warm-start state play the part weights play in a
model: the tests turn a JAX ``Scenario`` / ``ScenarioBatch`` /
``BatchWarmStart`` / ``WindowState`` into numpy arrays and build the port's
counterpart from them with these functions, so that both packages solve the
same instance.  Stream events cross as plain records of Python scalars
(``event_from_record``).  ``lm_params_from_numpy`` does the same for the
language models' weights, and ``lm_params_to_numpy`` turns the port's
parameters, or a gradient tree of their shape, back into JAX's layout;
``opt_state_from_numpy`` / ``opt_state_to_numpy`` do both for AdamW's
state.  ``lm_params_{to,from}_host`` and ``opt_state_{to,from}_host`` lay
out the same trees as CPU tensors, every dtype kept, for the checkpoints
of ``repro_torch.launch.train``: the stacking runs on the host.
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
           "lm_params_from_numpy", "lm_params_to_numpy",
           "opt_state_from_numpy", "opt_state_to_numpy",
           "lm_params_to_host", "lm_params_from_host", "opt_state_to_host",
           "opt_state_from_host", "to_numpy"]


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


def _converter(dev, dtype):
    """``conv(sub, index=None)``: a numpy subtree as tensors on ``dev``,
    indexed at ``index`` along its leading axis when that is not None."""
    def conv(sub, index=None):
        if isinstance(sub, dict):
            return {k: conv(v, index) for k, v in sub.items()}
        return _tensor(sub if index is None else np.asarray(sub)[index], dev,
                       dtype)
    return conv


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _from_jax_layout(cfg, tree: dict, conv):
    """The port's layer lists from JAX's stacked layout, each subtree
    converted by ``conv`` (:func:`_converter`).  A leaf may be a dict
    (AdamW's per-parameter state)."""
    def unstack(blocks, block_len):
        n_blocks = len(_first_leaf(blocks["l0"]))
        return [conv(blocks[f"l{p}"], i) for i in range(n_blocks)
                for p in range(block_len)]

    # the keys in ``init_params``' order, which sets the order of the
    # optimizer's sums over leaves (``global_norm``)
    out = {k: conv(tree[k]) for k in ("embed", "pos_embed") if k in tree}
    if cfg.is_encdec:
        out["enc_layers"] = unstack(tree["enc_blocks"], 1)
        out["layers"] = unstack(tree["dec_blocks"], 1)
    else:
        out["layers"] = [conv(layer) for layer in tree.get("head_layers", [])]
        out["layers"] += unstack(tree["blocks"], cfg.block_len)
    if len(out["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(out['layers'])} layers in the tree, "
                         f"{cfg.n_layers} in {cfg.name}")
    out.update({k: conv(tree[k]) for k in ("enc_final_norm", "final_norm",
                                           "unembed_w") if k in tree})
    return out


def _to_jax_layout(cfg, tree: dict, leaf, stack=None):
    """Inverse of :func:`_from_jax_layout`: ``leaf`` converts each tensor
    outside the blocks, and ``stack`` each list of one block position's
    tensors into one array along a new leading axis (by default
    ``np.stack`` of their ``leaf``; ``head_layers`` stay a list)."""
    if stack is None:
        stack = lambda ts: np.stack([leaf(t) for t in ts])  # noqa: E731

    def conv(sub):
        if isinstance(sub, dict):
            return {k: conv(v) for k, v in sub.items()}
        return leaf(sub)

    def restack(layer_list):
        if isinstance(layer_list[0], dict):
            return {k: restack([x[k] for x in layer_list])
                    for k in layer_list[0]}
        return stack(layer_list)

    def blocks(layer_list, block_len):
        return {f"l{p}": restack(layer_list[p::block_len])
                for p in range(block_len)}

    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers in the tree, "
                         f"{cfg.n_layers} in {cfg.name}")
    out = {k: conv(tree[k]) for k in ("embed", "pos_embed", "final_norm",
                                      "enc_final_norm", "unembed_w")
           if k in tree}
    if cfg.is_encdec:
        out["enc_blocks"] = blocks(tree["enc_layers"], 1)
        out["dec_blocks"] = blocks(tree["layers"], 1)
    else:
        first = cfg.moe.first_k_dense if cfg.moe else 0
        if first:
            out["head_layers"] = [conv(x) for x in tree["layers"][:first]]
        out["blocks"] = blocks(tree["layers"][first:], cfg.block_len)
    return out


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 as ml_dtypes' ``bfloat16``, the
    type JAX's bfloat16 arrays convert to (numpy has none), bit for bit."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _stack_on_host(ts) -> torch.Tensor:
    """One CPU tensor of ``ts`` stacked along a new leading axis, each
    copied straight from its device into its slice: nothing is stacked on
    the card."""
    out = torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype)
    for dst, t in zip(out, ts):
        dst.copy_(t.detach())
    return out


def _host_converter(dev):
    """:func:`_converter`'s counterpart for a tree of CPU tensors: a leaf,
    or its slice at ``index`` along the leading axis, moved to ``dev``
    with its dtype kept."""
    def conv(sub, index=None):
        if isinstance(sub, dict):
            return {k: conv(v, index) for k, v in sub.items()}
        return (sub if index is None else sub[index]).to(dev)
    return conv


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
    return _from_jax_layout(cfg, tree,
                            _converter(resolve_device(device), dtype))


def lm_params_to_numpy(cfg, params: dict) -> dict:
    """JAX's ``init_params`` layout, as nested dicts of numpy arrays, of the
    port's parameters or of any tree of their shape (a gradient): the
    inverse of :func:`lm_params_from_numpy`.  ``layers`` is restacked into
    ``head_layers`` plus ``blocks`` (``l0`` ... ``l{block_len-1}``), or
    ``enc_blocks`` / ``dec_blocks``; bfloat16 leaves come out as ml_dtypes'
    ``bfloat16``."""
    return _to_jax_layout(cfg, params, _leaf_to_numpy)


def opt_state_from_numpy(cfg, tree: dict, *, device="cuda") -> dict:
    """The port's AdamW state (``repro_torch.optim.adamw_init``'s layout)
    from JAX's ``adamw_init`` state as nested dicts of numpy arrays.

    ``tree["mu"]`` has the parameters' layout with a dict a leaf (``m``,
    ``v`` and ``master``, or int8 ``m`` / ``v`` of ``q`` and ``scale``);
    it is unstacked as :func:`lm_params_from_numpy` unstacks parameters,
    every dtype kept.  ``step`` becomes an int32 scalar tensor."""
    dev = resolve_device(device)
    return {"mu": _from_jax_layout(cfg, tree["mu"], _converter(dev, None)),
            "step": _tensor(np.asarray(tree["step"], dtype=np.int32), dev,
                            None)}


def opt_state_to_numpy(cfg, state: dict) -> dict:
    """JAX's ``adamw_init`` layout of the port's AdamW state: the inverse of
    :func:`opt_state_from_numpy`."""
    return {"mu": _to_jax_layout(cfg, state["mu"], _leaf_to_numpy),
            "step": _leaf_to_numpy(state["step"])}


def lm_params_to_host(cfg, params: dict) -> dict:
    """JAX's ``init_params`` layout of the port's parameters, as CPU
    tensors that share no memory with them (each block position's layers
    copied into one stacked tensor on the host); dtypes kept.  The tree
    ``repro_torch.checkpoint`` saves, as ``repro.launch.train`` does."""
    return _to_jax_layout(cfg, params, _host_copy, _stack_on_host)


def lm_params_from_host(cfg, tree: dict, *, device="cuda") -> dict:
    """The inverse of :func:`lm_params_to_host`: the port's layer lists on
    ``device``, unstacked on the host, every dtype kept."""
    return _from_jax_layout(cfg, tree,
                            _host_converter(resolve_device(device)))


def opt_state_to_host(cfg, state: dict) -> dict:
    """JAX's ``adamw_init`` layout of the port's AdamW state as CPU
    tensors, as :func:`lm_params_to_host` lays out parameters."""
    return {"mu": _to_jax_layout(cfg, state["mu"], _host_copy,
                                 _stack_on_host),
            "step": _host_copy(state["step"])}


def opt_state_from_host(cfg, tree: dict, *, device="cuda") -> dict:
    """The inverse of :func:`opt_state_to_host`, on ``device``."""
    conv = _host_converter(resolve_device(device))
    return {"mu": _from_jax_layout(cfg, tree["mu"], conv),
            "step": conv(tree["step"])}
