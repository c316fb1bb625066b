"""Wrappers of the hand-written CUDA RM price sweep (``csrc/gnep_sweep.cu``).

Counterpart of ``repro.kernels.gnep_sweep.kernel``.  A wrapper given CPU
tensors returns the plain PyTorch version (``ref.py``); given CUDA tensors
it launches the kernel on PyTorch's current stream or raises.  Each wrapper
counts its own launches in its ``launches`` attribute.  Both take the input
dtype (float32 or float64): the TPU path's forced f32 cast is not ported.
The kernel reads and writes 16-byte vectors where the rows allow it and
single values otherwise; ``access_width`` picks the entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gnep_sweep.ref import reference, reference_batched

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {f"rm_sweep_{v}{t}": [_P] * 6 + [_I] * 3 + [_P]
               for v in ("", "v16_") for t in ("f32", "f64")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_INT_MAX = 2**31 - 1


def access_width(inc, p_sorted) -> int:
    """Values per access the kernel takes for these operands: one 16-byte
    vector (2 in f64, 4 in f32) where every row of ``inc`` and ``p_sorted``
    (and of the freshly allocated fill) starts on a 16-byte boundary, which
    needs N * element size a multiple of 16 and 16-byte aligned bases;
    else 1, the same kernel with scalar access."""
    return _width(inc.shape[-1], inc.element_size(), inc.data_ptr(),
                  p_sorted.data_ptr())


def _width(n, size, inc_ptr, p_ptr) -> int:
    vec = 16 // size
    aligned = inc_ptr % 16 == 0 and p_ptr % 16 == 0
    return vec if n % vec == 0 and aligned else 1


def _launch(inc, spare, p_sorted, what):
    """Check the (B, Nc, N) / (B,) / (B, N) operands and launch once."""
    tensors = (inc, spare, p_sorted)
    if not all(t.is_cuda and t.device == inc.device for t in tensors):
        raise ValueError(f"{what}: operands must all be CPU tensors (plain "
                         "version) or all on one CUDA device (kernel), got "
                         f"{[str(t.device) for t in tensors]}")
    if inc.dtype not in _SUFFIX or any(t.dtype != inc.dtype for t in tensors):
        raise TypeError(f"{what}: operands must share one dtype of float32 / "
                        f"float64, got {[t.dtype for t in tensors]}")
    B, Nc, N = inc.shape
    if spare.shape != (B,) or p_sorted.shape != (B, N):
        raise ValueError(f"{what}: shapes inc {tuple(inc.shape)}, spare "
                         f"{tuple(spare.shape)}, p_sorted "
                         f"{tuple(p_sorted.shape)} do not agree")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if max(B, Nc, N) > _INT_MAX:
        raise ValueError(f"{what}: a dimension exceeds the kernel's int range")
    fill = torch.empty_like(inc)
    sum_fill = inc.new_empty((B, Nc))
    p_fill = inc.new_empty((B, Nc))
    lib = _build.load("gnep_sweep", _SIGNATURES)
    inc_ptr, p_ptr = inc.data_ptr(), p_sorted.data_ptr()
    v16 = "v16_" if _width(N, inc.element_size(), inc_ptr, p_ptr) > 1 else ""
    fn = getattr(lib, f"rm_sweep_{v16}{_SUFFIX[inc.dtype]}")
    err = fn(inc_ptr, spare.data_ptr(), p_ptr, fill.data_ptr(),
             sum_fill.data_ptr(), p_fill.data_ptr(), B, Nc, N,
             _build.stream_of(inc))
    _build.check(lib, err, what)
    return fill, sum_fill, p_fill


def rm_sweep_batched(inc, spare, p_sorted):
    """Batched RM price sweep: B instances in one kernel launch.

    inc: (B, Nc, N); spare: (B,); p_sorted: (B, N), all one float dtype.
    Returns (fill (B, Nc, N), sum_fill (B, Nc), p_fill (B, Nc))."""
    if inc.device.type == "cpu":
        return reference_batched(inc, spare, p_sorted)
    out = _launch(inc, spare, p_sorted, "rm_sweep_batched")
    rm_sweep_batched.launches += 1
    return out


def rm_sweep(inc, spare, p_sorted):
    """RM price sweep of one instance: the batched kernel at B = 1.

    inc: (Nc, N); spare: scalar (0-d tensor or float); p_sorted: (N,).
    Returns (fill (Nc, N), sum_fill (Nc,), p_fill (Nc,))."""
    if inc.device.type == "cpu":
        return reference(inc, spare, p_sorted)
    spare = torch.as_tensor(spare, dtype=inc.dtype, device=inc.device)
    fill, sum_fill, p_fill = _launch(inc[None], spare.reshape(1),
                                     p_sorted[None], "rm_sweep")
    rm_sweep.launches += 1
    return fill[0], sum_fill[0], p_fill[0]


rm_sweep_batched.launches = 0
rm_sweep.launches = 0
