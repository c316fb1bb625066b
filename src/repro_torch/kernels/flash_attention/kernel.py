"""Wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention.kernel``.  Given CPU tensors
it returns the plain version (``ref.reference``, the dense oracle), whose
autograd works; given CUDA tensors it launches the kernel on PyTorch's
current stream or raises, and counts the launch in
``flash_attention.launches``.  The kernel has no backward yet (ROADMAP
Queue 1 item 23): under grad, an operand that requires grad is refused
before anything is built or launched (``_build.refuse_grad``).  The TPU
kernel's ``block_q`` / ``block_k`` tiling has no counterpart here: the CUDA
kernel uses its own tiles and masks ragged edges itself, so it takes any
Sq and Skv.  It takes bfloat16 or float32 with head width 32, 64 or 128, reads
q / k / v through their strides (the last axis contiguous) and writes a
contiguous output in q's dtype.  bfloat16 at head width 64 or 128 runs the
tensor-core kernel, which reads q / k / v by TMA and so also needs what
``_tma_ok`` checks; float32, and bfloat16 at head width 32, run the
CUDA-core kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {f"flash_attention_{t}": [_P] * 4 + [_I] * 6 + [_L] * 9
               + [_I, ctypes.c_float, _P] for t in ("f32", "bf16")}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_HEAD_DIMS = (32, 64, 128)
_TMA_HEAD_DIMS = (64, 128)


def _tma_ok(t) -> bool:
    """Whether TMA can read ``t``, a (B, S, H, hd) operand whose head axis is
    contiguous: its base is 16-byte aligned and its batch, row and head
    strides are multiples of 16 bytes (an axis of extent 1 is never
    stepped, so its stride does not matter)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or st * size % 16 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]))


def flash_attention(q, k, v, *, causal=True):
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    if q.device.type == "cpu":
        return ref.reference(q, k, v, causal=causal)
    what = "flash_attention"
    args = (q, k, v)
    _build.refuse_grad(what, *args)
    if not all(t.is_cuda and t.device == q.device for t in args):
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
    if q.dtype == torch.bfloat16 and hd in _TMA_HEAD_DIMS:
        bad = [n for n, t in zip("qkv", args) if not _tma_ok(t)]
        if bad:
            raise ValueError(f"{what}: TMA needs a 16-byte aligned base and "
                             "batch, row and head strides of multiples of 16 "
                             f"bytes, which {', '.join(bad)} lack")
    o = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention", _SIGNATURES)
    fn = getattr(lib, f"{what}_{_SUFFIX[q.dtype]}")
    strides = [s for t in args for s in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
             Skv, Hq, Hkv, hd, *strides, int(causal), hd ** -0.5,
             _build.stream_of(q))
    _build.check(lib, err, what)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
