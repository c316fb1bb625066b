"""Wrapper of the hand-written CUDA chunked WKV6 (``csrc/wkv6.cu``).

Counterpart of ``repro.kernels.rwkv6.kernel``.  Given CPU tensors it
returns the plain chunked version (``ref.chunked_reference``); given CUDA
tensors it launches the kernel on PyTorch's current stream or raises, and
counts the launch in ``wkv6.launches``.  Beyond the TPU kernel it takes an
optional initial state ``S0`` (zeros by default, the TPU kernel's
function), so that every chunked ``time_mix`` runs through it, a carried
state included.  The kernel takes float32 operands with K, V <= 64.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"wkv6_f32": [_P] * 8 + [_I] * 6 + [_P]}
_MAX_KV = 64


def wkv6(r, k, v, w_log, u, *, chunk=64, S0=None):
    """r/k/w_log: (B,T,H,K); v: (B,T,H,V); u: (H,K); S0: (B,H,K,V) or None.

    Returns (y (B,T,H,V) in r's dtype, S (B,H,K,V) float32).
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    if T % chunk:
        raise ValueError(f"T={T} must be divisible by chunk={chunk}")
    if r.device.type == "cpu":
        if S0 is None:
            S0 = torch.zeros((B, H, K, V), dtype=torch.float32)
        return ref.chunked_reference(r, k, v, w_log, u, S0, chunk=chunk)
    what = "wkv6"
    args = (r, k, v, w_log, u) + (() if S0 is None else (S0,))
    if not all(t.is_cuda and t.device == r.device for t in args):
        raise ValueError(f"{what}: operands must all be CPU tensors (plain "
                         "version) or all on one CUDA device (kernel), got "
                         f"{[str(t.device) for t in args]}")
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError(f"{what}: the kernel takes float32 operands, got "
                        f"{[t.dtype for t in args]}")
    if (k.shape != r.shape or w_log.shape != r.shape
            or v.shape[:3] != (B, T, H) or u.shape != (H, K)
            or (S0 is not None and S0.shape != (B, H, K, V))):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in args]} "
                         "do not agree with (B,T,H,K) x3, (B,T,H,V), (H,K), "
                         "(B,H,K,V)")
    if not (1 <= K <= _MAX_KV and 1 <= V <= _MAX_KV):
        raise ValueError(f"{what}: the kernel takes K, V <= {_MAX_KV}, got "
                         f"K={K} V={V}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{what}: operands must be contiguous")
    y = torch.empty_like(v)
    S = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    lib = _build.load("wkv6", _SIGNATURES)
    err = lib.wkv6_f32(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w_log.data_ptr(), u.data_ptr(),
                       None if S0 is None else S0.data_ptr(), y.data_ptr(),
                       S.data_ptr(), B, T, H, K, V, chunk,
                       _build.stream_of(r))
    _build.check(lib, err, what)
    wkv6.launches += 1
    return y, S


wkv6.launches = 0
