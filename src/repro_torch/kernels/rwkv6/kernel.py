"""Wrapper of the hand-written CUDA chunked WKV6 (``csrc/wkv6.cu``).

Counterpart of ``repro.kernels.rwkv6.kernel``.  Given CPU tensors it
returns the plain chunked version (``ref.chunked_reference``), whose
autograd works; given CUDA tensors it launches the kernel on PyTorch's
current stream or raises.  The kernel has no backward yet (ROADMAP Queue 1
item 23): under grad, an operand that requires grad is refused before
anything is built or launched (``_build.refuse_grad``).
Beyond the TPU kernel it takes an optional initial state ``S0`` (zeros by
default, the TPU kernel's function), so that every chunked ``time_mix``
runs through it, a carried state included.  The kernel takes float32
operands with K, V <= 64.

Two routes (``route``): a chunk that is a multiple of 64, with K == V a
multiple of 4 and 16-byte aligned operands, runs the chunk-parallel
kernels on the tensor cores (state, prefix and output passes: three CUDA
kernels); any other chunk runs the per-head kernel.  ``wkv6.launches``
counts wrapper calls that launched, one per call whatever the route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6 import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"wkv6_f32": [_P] * 8 + [_I] * 6 + [_P],
               "wkv6_chunked_f32": [_P] * 12 + [_I] * 6 + [_P]}
_MAX_KV = 64
_SUB = 64        # rows of the chunk-parallel route's sub-tile
PASSES = {"state": 1, "prefix": 2, "output": 4}


def route(r, k, v, w_log, chunk) -> str:
    """``"chunk-parallel"`` or ``"per-head"``: the kernel a call with these
    operands and this chunk runs on the card."""
    K, V = r.shape[-1], v.shape[-1]
    if (chunk % _SUB == 0 and K == V and K % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in (r, k, v, w_log))):
        return "chunk-parallel"
    return "per-head"


def _check(r, k, v, w_log, u, S0):
    what = "wkv6"
    B, T, H, K = r.shape
    V = v.shape[-1]
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


def _launcher(r, k, v, w_log, u, S0, chunk):
    """(y, S, lib, launch): ``launch(passes)`` runs the kernels of the
    call's route into y and S and returns the C entry's error code;
    ``passes`` (a mask of ``PASSES``) picks kernels of the chunk-parallel
    route."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    y = torch.empty_like(v)
    S = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    lib = _build.load("wkv6", _SIGNATURES)
    ptrs = [t.data_ptr() for t in (r, k, v, w_log, u)] + [
        None if S0 is None else S0.data_ptr(), y.data_ptr(), S.data_ptr()]
    stream = _build.stream_of(r)
    if route(r, k, v, w_log, chunk) == "per-head":
        def launch(passes=7):
            return lib.wkv6_f32(*ptrs, B, T, H, K, V, chunk, stream)
        return y, S, lib, launch
    n = T // chunk
    f32 = dict(dtype=torch.float32, device=r.device)
    scratch = (torch.empty((B, H, n, K, K), **f32),          # U, then S_c
               torch.empty((B, H, n, chunk // _SUB, K), **f32),  # carries
               torch.empty((B, H, n, K), **f32),             # Z
               torch.empty((B, H, n, K), **f32))             # e^{LW_end}
    scratch_ptrs = [t.data_ptr() for t in scratch]

    def launch(passes=7):
        return lib.wkv6_chunked_f32(*ptrs, *scratch_ptrs, B, T, H, K, chunk,
                                    passes, stream)
    return y, S, lib, launch


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
    _build.refuse_grad("wkv6", r, k, v, w_log, u, S0)
    _check(r, k, v, w_log, u, S0)
    y, S, lib, launch = _launcher(r, k, v, w_log, u, S0, chunk)
    _build.check(lib, launch(), "wkv6")
    wkv6.launches += 1
    return y, S


wkv6.launches = 0


def pass_launchers(r, k, v, w_log, u, *, chunk, S0=None) -> dict:
    """Pass name -> a callable that launches that kernel of the
    chunk-parallel route alone on this call's buffers, to time it (it counts
    no launch; the prefix pass rewrites its scratch in place, so only the
    first full call's values mean anything)."""
    _build.refuse_grad("wkv6", r, k, v, w_log, u, S0)
    _check(r, k, v, w_log, u, S0)
    if route(r, k, v, w_log, chunk) != "chunk-parallel":
        raise ValueError("wkv6: the per-head route has one kernel")
    _, _, lib, launch = _launcher(r, k, v, w_log, u, S0, chunk)
    return {name: (lambda bit=bit: _build.check(lib, launch(bit), "wkv6"))
            for name, bit in PASSES.items()}
