"""Wrappers of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``, forward; ``csrc/flash_attention_bwd.cu``,
backward).

Counterpart of ``repro.kernels.flash_attention.kernel``.  Given CPU tensors
``flash_attention`` returns the plain version (``ref.reference``, the dense
oracle), whose autograd works; given CUDA tensors it launches the kernel on
PyTorch's current stream or raises, and counts the launch in
``flash_attention.launches``.  Under grad, with an operand that requires
grad, it runs ``_FlashFunction``: the forward launches the kernel with its
per-row logsumexp and saves q, k, v, the output and the logsumexp; the
backward launches the backward kernels (``flash_attention_bwd``, counted in
``flash_attention_bwd.launches``) on the output's cotangent.  Under
``no_grad`` / ``inference_mode`` the forward runs alone, with no
logsumexp.  The TPU kernel's ``block_q`` / ``block_k`` tiling has no
counterpart here: the CUDA kernels use their own tiles and mask ragged
edges themselves, so they take any Sq and Skv.  They take bfloat16 or
float32 with head width 32, 64 or 128, read q / k / v through their
strides (the last axis contiguous) and write contiguous results in q's
dtype.  ``route`` names the kernels a call runs, one of ``ROUTES`` by
dtype, the same both ways: bfloat16 at every head width runs
``flash_fwd_wgmma``, then ``flash_bwd_dq_wgmma`` and
``flash_bwd_dkdv_wgmma`` ("tensor_cores": wgmma, TMA; q, k and v, and in
the backward o and do, must pass ``_tma_ok``, checked before anything
launches, so a refused input fails before the forward and not inside
autograd); float32 runs ``flash_fwd_tf32``, then ``flash_bwd_dq_tf32``
and ``flash_bwd_dkdv_tf32`` ("split_tf32": mma.sync on the TF32 tensor
cores, each product split in three, any strides).
``flash_attention.route_launches`` and
``flash_attention_bwd.route_launches`` count each direction's launches by
route.

Each launch is a dispatcher operator (``torch.ops.repro_torch.
flash_attention`` and ``flash_attention_bwd``) with a CUDA implementation,
which launches, and a Meta one, which returns empty tensors of the
kernel's outputs and launches nothing: a meta tensor takes the card's
route through the same operators, so the dry run
(``repro_torch.launch.dryrun``) counts the kernels' own operations
(``fwd_ops`` / ``bwd_ops``, registered as the operators' FLOP formulas)
and their operands and results.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {f"flash_attention_{t}": [_P] * 5 + [_I] * 6 + [_L] * 9
               + [_I, ctypes.c_float, _P] for t in ("f32", "bf16")}
_BWD_SIGNATURES = {f"flash_attention_bwd_{t}": [_P] * 10 + [_I] * 6
                   + [_L] * 9 + [_I, ctypes.c_float, _P]
                   for t in ("f32", "bf16")}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_HEAD_DIMS = (32, 64, 128)


def _tma_ok(t) -> bool:
    """Whether TMA can read ``t``, a (B, S, H, hd) operand whose head axis is
    contiguous: its base is 16-byte aligned and its batch, row and head
    strides are multiples of 16 bytes (an axis of extent 1 is never
    stepped, so its stride does not matter)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or st * size % 16 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]))


ROUTES = ("tensor_cores", "split_tf32")


def route(q) -> str:
    """One of ``ROUTES``: the kernels a call with ``q`` (B, S, H, hd) runs,
    forward and backward, ``"tensor_cores"`` (wgmma) for bfloat16,
    ``"split_tf32"`` (mma.sync, each product as three TF32 products) for
    float32."""
    return "tensor_cores" if q.dtype == torch.bfloat16 else "split_tf32"


def _need_tma(what, operands):
    bad = [name for name, t in operands.items() if not _tma_ok(t)]
    if bad:
        raise ValueError(f"{what}: TMA needs a 16-byte aligned base and "
                         "batch, row and head strides of multiples of 16 "
                         f"bytes, which {', '.join(bad)} lack")


def pairs(Sq, Skv, causal) -> int:
    """(query, key) pairs the mask keeps: key position <= query position
    where causal (the kernels' mask, both counted from 0)."""
    if not causal:
        return Sq * Skv
    n = min(Sq, Skv)
    return n * (n + 1) // 2 + (Sq - n) * Skv


def fwd_ops(B, Sq, Skv, Hq, hd, causal) -> int:
    """Operations of the forward: two products (Q K^T and P V) of 2 hd
    each for every kept pair of every query head."""
    return 4 * hd * B * Hq * pairs(Sq, Skv, causal)


def bwd_ops(B, Sq, Skv, Hq, hd, causal) -> int:
    """Operations of the backward: five products (S, dP, dV, dQ and dK) of
    2 hd each for every kept pair of every query head."""
    return 5 * 2 * hd * B * Hq * pairs(Sq, Skv, causal)


def _on_card(t, device) -> bool:
    """A CUDA tensor, or a meta one (the dry run's stand-in for the
    card), on ``device``."""
    return t.device.type in ("cuda", "meta") and t.device == device


def _check(q, k, v):
    """Raise for operands the kernels do not take.  bfloat16 runs the wgmma
    kernels both ways, which read q, k and v by TMA, so a bf16 view that
    ``_tma_ok`` refuses (a base or a stride off 16 bytes) is refused at
    every head width, with or without grad; no configuration makes one.
    float32 takes any strides."""
    what = "flash_attention"
    args = (q, k, v)
    if not all(_on_card(t, q.device) for t in args):
        raise ValueError(f"{what}: operands must all be CPU tensors (plain "
                         "version) or all on one CUDA device (kernel), got "
                         f"{[str(t.device) for t in args]}")
    if q.dtype not in _SUFFIX or any(t.dtype != q.dtype for t in args):
        raise TypeError(f"{what}: operands must share one dtype of float32 / "
                        f"bfloat16, got {[t.dtype for t in args]}")
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or Hkv < 1 or Hq % Hkv or min(Sq, Skv) < 1):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head widths {_HEAD_DIMS}, "
                         f"got {hd}")
    if any(t.stride(-1) != 1 for t in args):
        raise ValueError(f"{what}: the head axis must be contiguous")
    if route(q) == "tensor_cores":
        _need_tma(what, {"q": q, "k": k, "v": v})


def _strides(q, k, v):
    return [s for t in (q, k, v) for s in t.stride()[:3]]


def _forward(q, k, v, causal, lse=None):
    """Launch the forward kernel; write each row's logsumexp into ``lse``
    (B, Hq, Sq) f32 where one is given."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    o = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention", _SIGNATURES)
    fn = getattr(lib, f"flash_attention_{_SUFFIX[q.dtype]}")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(), B, Sq, Skv, Hq, Hkv, hd,
             *_strides(q, k, v), int(causal), hd ** -0.5, _build.stream_of(q))
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.route_launches[route(q)] += 1
    return o


def _bwd_outputs(q, k):
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    dq = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, Hkv, hd), dtype=q.dtype, device=q.device)
    return dq, dk, torch.empty_like(dk)


def _bwd_cuda(q, k, v, o, lse, do, causal):
    """The backward operator's CUDA implementation: one launch of the
    route's two kernels."""
    what = "flash_attention_bwd"
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    dq, dk, dv = _bwd_outputs(q, k)
    # each 64-row query tile's lse log2 e and D, 512 bytes a tile, on
    # either route
    stats = torch.empty((B, Hq, -(-Sq // 64), 2, 64), dtype=torch.float32,
                        device=q.device)
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    fn = getattr(lib, f"{what}_{_SUFFIX[q.dtype]}")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), stats.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, Hq, Hkv, hd,
             *_strides(q, k, v), int(causal), hd ** -0.5, _build.stream_of(q))
    _build.check(lib, err, what)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[route(q)] += 1
    return dq, dk, dv


def _fwd_cuda(q, k, v, causal, with_lse):
    """The forward operator's CUDA implementation: [o], or [o, lse]."""
    if not with_lse:
        return [_forward(q, k, v, causal)]
    B, Sq, Hq, _ = q.shape
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    return [_forward(q, k, v, causal, lse), lse]


def _fwd_meta(q, k, v, causal, with_lse):
    B, Sq, Hq, hd = q.shape
    o = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if not with_lse:
        return [o]
    return [o, torch.empty((B, Hq, Sq), dtype=torch.float32,
                           device=q.device)]


def _bwd_meta(q, k, v, o, lse, do, causal):
    return _bwd_outputs(q, k)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "bool with_lse) -> Tensor[]")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
            "Tensor lse, Tensor do, bool causal) -> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_attention", _fwd_cuda, "CUDA")
_LIB.impl("flash_attention", _fwd_meta, "Meta")
_LIB.impl("flash_attention_bwd", _bwd_cuda, "CUDA")
_LIB.impl("flash_attention_bwd", _bwd_meta, "Meta")


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _fwd_flops(q_shape, k_shape, v_shape, causal, with_lse, *args,
               out_shape=None, **kwargs):
    B, Sq, Hq, hd = q_shape
    return fwd_ops(B, Sq, k_shape[1], Hq, hd, causal)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
               causal, *args, out_shape=None, **kwargs):
    B, Sq, Hq, hd = q_shape
    return bwd_ops(B, Sq, k_shape[1], Hq, hd, causal)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True):
    """(dq, dk, dv) in q's dtype from the forward's output ``o``, its
    logsumexp ``lse`` (B, Hq, Sq) f32 and the output's cotangent ``do``:
    the backward kernels on CUDA tensors (q / k / v as the forward takes
    them; o and do contiguous, in q's dtype), one launch of the route's two
    kernels, counted in ``flash_attention_bwd.launches`` and by route in
    ``flash_attention_bwd.route_launches``; on meta tensors the operator's
    outputs alone."""
    what = "flash_attention_bwd"
    _check(q, k, v)
    B, Sq, Hq, hd = q.shape
    for name, t, shape, dtype in (("o", o, q.shape, q.dtype),
                                  ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (B, Hq, Sq), torch.float32)):
        if (t.device != q.device or tuple(t.shape) != tuple(shape)
                or t.dtype != dtype or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"tensor of shape {tuple(shape)} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if route(q) == "tensor_cores":
        _need_tma(what, {"o": o, "do": do})
    return torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, lse, do,
                                                     causal)


class _FlashFunction(torch.autograd.Function):
    """The forward kernel with its logsumexp; the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = torch.ops.repro_torch.flash_attention(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, o, lse,
                                    do.to(q.dtype).contiguous(),
                                    causal=ctx.causal)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def flash_attention(q, k, v, *, causal=True):
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    if q.device.type == "cpu":
        return ref.reference(q, k, v, causal=causal)
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashFunction.apply(q, k, v, causal)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, False)[0]


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
flash_attention_bwd.launches = 0
flash_attention_bwd.route_launches = dict.fromkeys(ROUTES, 0)
