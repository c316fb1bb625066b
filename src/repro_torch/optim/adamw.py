"""AdamW with memory-tiered state, and its learning-rate schedules.

Counterpart of ``repro.optim.adamw``.  State tiers:
  * "f32"  — an f32 master copy and f32 (m, v)
  * "bf16" — bf16 (m, v), no master (parameters updated in f32, then cast)
  * "int8" — blockwise-quantized (m, v) as in 8-bit Adam (blocks of 256
             along the last axis, a per-block absmax scale), no master

Schedules: cosine, WSD (warmup-stable-decay, MiniCPM arXiv:2404.06395) and
const, evaluated in f32.

The port's parameters are nested dicts and lists of tensors
(``repro_torch.models``); the state mirrors them leaf for leaf, walked with
``repro_torch.utils.tree_map``.  Where JAX stacks a block's layers along a
leading axis, the port keeps one tensor a layer: the int8 blocks run along
the last axis, which stacking does not touch, so each layer quantizes as
its slice of JAX's stacked leaf does.  Everything runs on the tensors' own
device, without autograd, and returns new trees: the parameters and state
passed in are never changed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.utils import tree_leaves, tree_map

F32 = torch.float32
BLOCK = 256


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "f32"          # f32 | bf16 | int8
    schedule: str = "cosine"          # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1           # WSD: final decay fraction of steps


def _div(a, b):
    """``a / b`` rounded once, as JAX divides: torch's CUDA division by a
    Python number (or a CPU scalar) multiplies by its reciprocal, which can
    round differently, so ``b`` becomes a tensor on ``a``'s device."""
    return torch.div(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def make_schedule(oc: OptConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an integer or a tensor) -> the f32 learning rate, on the
    step's device."""
    def sched(step):
        step = torch.as_tensor(step).to(F32)
        warm = torch.clamp(_div(step, max(oc.warmup_steps, 1)), max=1.0)
        if oc.schedule == "const":
            return oc.lr * warm
        if oc.schedule == "cosine":
            t = torch.clamp(_div(step - oc.warmup_steps,
                                 max(oc.total_steps - oc.warmup_steps, 1)),
                            0, 1)
            return oc.lr * warm * 0.5 * (1 + torch.cos(math.pi * t))
        # WSD: stable at lr, then a linear decay to 0.1 lr over the last
        # decay_frac of the steps
        decay_start = oc.total_steps * (1 - oc.decay_frac)
        t = torch.clamp(_div(step - decay_start,
                             max(oc.total_steps - decay_start, 1)), 0, 1)
        return oc.lr * warm * (1 - t * (1 - 0.1))
    return sched


# ---------------------------- int8 block quant -----------------------------

def _q8(x):
    """Blockwise int8 along the last axis, zero-padded to a multiple of
    ``BLOCK``: ``{"q": int8 (..., padded last), "scale": f32 (..., blocks)}``.
    The scale is the block's absmax / 127, at least 1e-12; ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    last = x.shape[-1]
    pad = (-last) % BLOCK
    xp = F.pad(x, (0, pad))
    nblk = (last + pad) // BLOCK
    blocks = xp.reshape(*x.shape[:-1], nblk, BLOCK)
    scale = _div(torch.amax(torch.abs(blocks), dim=-1, keepdim=True), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q.reshape(*x.shape[:-1], last + pad),
            "scale": scale[..., 0].to(F32)}


def _dq8(s, shape):
    """f32 values of the int8 state ``s`` (from :func:`_q8`), cut to
    ``shape``'s last axis."""
    last = shape[-1]
    q = s["q"]
    nblk = q.shape[-1] // BLOCK
    blocks = q.to(F32).reshape(*q.shape[:-1], nblk, BLOCK)
    deq = blocks * s["scale"][..., None]
    return deq.reshape(*q.shape[:-1], q.shape[-1])[..., :last]


# ---------------------------- state init / update ---------------------------

@torch.no_grad()
def adamw_init(params, oc: OptConfig):
    """Zero moments (and, for the f32 tier, an f32 master copy that shares
    no memory with the parameters) for every leaf, on its device.
    Returns ``{"mu": <params' structure, a dict a leaf>, "step": int32 0}``
    with the step on the first leaf's device."""
    def one(x):
        if oc.state_dtype == "f32":
            return {"m": torch.zeros(x.shape, dtype=F32, device=x.device),
                    "v": torch.zeros(x.shape, dtype=F32, device=x.device),
                    "master": x.to(F32, copy=True)}
        if oc.state_dtype == "bf16":
            return {"m": torch.zeros(x.shape, dtype=torch.bfloat16,
                                     device=x.device),
                    "v": torch.zeros(x.shape, dtype=torch.bfloat16,
                                     device=x.device)}
        zero = torch.zeros(x.shape, dtype=F32, device=x.device)
        return {"m": _q8(zero), "v": _q8(zero)}
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32 (leaf sums added in
    the tree's order)."""
    return torch.sqrt(sum(torch.sum(x.to(F32) ** 2)
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, oc: OptConfig):
    """One AdamW step: global-norm clipping to ``oc.clip_norm``, bias
    correction, decoupled weight decay on every leaf.

    ``grads`` has the parameters' structure.  Returns ``(new_params,
    new_state, {"lr", "grad_norm"})``; new parameters keep each leaf's
    dtype.
    """
    sched = make_schedule(oc)
    step = state["step"] + 1
    lr = sched(step)
    gn = global_norm(grads)
    # ``float / tensor`` would be a reciprocal and a product
    clip = torch.clamp(torch.div(torch.full_like(gn, oc.clip_norm),
                                 torch.clamp(gn, min=1e-12)), max=1.0)
    bc1 = 1 - oc.beta1 ** step.to(F32)
    bc2 = 1 - oc.beta2 ** step.to(F32)

    def one(x, g, s):
        g = g.to(F32) * clip
        if oc.state_dtype == "int8":
            m = _dq8(s["m"], x.shape)
            v = _dq8(s["v"], x.shape)
        else:
            m = s["m"].to(F32)
            v = s["v"].to(F32)
        m = oc.beta1 * m + (1 - oc.beta1) * g
        v = oc.beta2 * v + (1 - oc.beta2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
        base = s["master"] if oc.state_dtype == "f32" else x.to(F32)
        new = base - lr * (upd + oc.weight_decay * base)
        if oc.state_dtype == "int8":
            out = {"m": _q8(m), "v": _q8(v)}
        else:
            out = {"m": m.to(s["m"].dtype), "v": v.to(s["v"].dtype)}
        if oc.state_dtype == "f32":
            out["master"] = new
        return new.to(x.dtype), out

    if len(tree_leaves(grads)) != len(tree_leaves(params)):
        raise ValueError(f"{len(tree_leaves(grads))} gradient leaves for "
                         f"{len(tree_leaves(params))} parameters")
    new_params, new_mu = _zip_map(one, params, grads, state["mu"])
    return new_params, {"mu": new_mu, "step": step}, {"lr": lr,
                                                       "grad_norm": gn}


def _zip_map(fn, p, g, s):
    """Walk the parameters' structure with the gradients' and the state's
    beside it; ``fn(x, g, s)`` at each parameter returns (new x, new s).
    Returns the two new trees."""
    if isinstance(p, torch.Tensor):
        return fn(p, g, s)
    if isinstance(p, dict):
        pairs = {k: _zip_map(fn, p[k], g[k], s[k]) for k in p}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    pairs = [_zip_map(fn, *xs) for xs in zip(p, g, s)]
    return [a for a, _ in pairs], [b for _, b in pairs]
