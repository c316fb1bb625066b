"""Wrapper of the hand-written CUDA fused iteration middle (``csrc/gnep_iter.cu``).

Counterpart of ``repro.kernels.gnep_iter.kernel``.  Given CPU tensors the
wrapper returns the plain version (``ref.fused_middle_reference``); given
CUDA tensors it launches the kernel on PyTorch's current stream or raises,
and counts the launch in ``fused_iter_sweep.launches``.  The kernel writes
only the winning candidate's fill row, ``(B, N)``, not the ``(B, Nc, N)``
fill tensor of the TPU kernel: the solver takes nothing else from it.

The kernel skips work that cannot change a bit of any output.  It walks
each lane's classes only up to the last one that can move an accumulator
(a class with zero headroom and a finite penalty rate adds +-0 to sums that
are never -0; padded classes are such classes, and sort last).  It walks
each distinct candidate price once: ``obj`` is a function of a candidate's
bits and the lane's data, so every candidate carrying ``rho_bar``'s bits
(the padded slots, column N and, at a cold start, every bid) takes the
objective of one walk, and counts in the first-max argmax at its smallest
index, where ``torch.argmax`` finds the first of equal maxima.  Its grid
(a block a lane, at most as many as are resident at once) is sized inside
the C launcher, from the occupancy and SM count it queries once a device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gnep_iter.ref import fused_middle_reference

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {f"fused_iter_sweep_{t}": [_P] * 13 + [_I] * 3 + [_P]
               for t in ("f32", "f64")}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def fused_iter_sweep(bids_sorted, inc_max_sorted, p_sorted, cand, spare,
                     rho_bar, sum_r_low, p_r_low, const):
    """One-launch fill / objective / argmax middle of an Alg. 4.1 iteration.

    Parameters
    ----------
    bids_sorted, inc_max_sorted, p_sorted : torch.Tensor
        (B, N) effective bids, fill headroom (0 when masked) and masked
        penalty rates, all in greedy (p-descending) order.
    cand : torch.Tensor
        (B, Nc) candidate prices, Nc >= 1.
    spare, rho_bar, sum_r_low, p_r_low, const : torch.Tensor
        (B,) slack, floor price and the objective's lane constants.

    Returns
    -------
    fill_best : torch.Tensor
        (B, N) greedy fill of the winning candidate (greedy order).
    obj : torch.Tensor
        (B, Nc) the (P5) objective of every candidate.
    best : torch.Tensor
        (B,) int64 winning candidate index (first maximum).
    rho : torch.Tensor
        (B,) winning candidate price.
    """
    args = (bids_sorted, inc_max_sorted, p_sorted, cand, spare, rho_bar,
            sum_r_low, p_r_low, const)
    if bids_sorted.device.type == "cpu":
        return fused_middle_reference(*args)
    what = "fused_iter_sweep"
    if not all(t.is_cuda and t.device == bids_sorted.device for t in args):
        raise ValueError(f"{what}: operands must all be CPU tensors (plain "
                         "version) or all on one CUDA device (kernel), got "
                         f"{[str(t.device) for t in args]}")
    dt = bids_sorted.dtype
    if dt not in _SUFFIX or any(t.dtype != dt for t in args):
        raise TypeError(f"{what}: operands must share one dtype of float32 / "
                        f"float64, got {[t.dtype for t in args]}")
    B, N = bids_sorted.shape
    Nc = cand.shape[-1]
    if (any(t.shape != (B, N) for t in args[:3]) or cand.shape != (B, Nc)
            or any(t.shape != (B,) for t in args[4:]) or Nc < 1):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in args]} "
                         "do not agree with (B, N) x3, (B, Nc >= 1), (B,) x5")
    if not all(t.is_contiguous() for t in args):
        raise ValueError(f"{what}: operands must be contiguous")
    fill_best = torch.empty_like(bids_sorted)
    obj = cand.new_empty((B, Nc))
    best = torch.empty((B,), dtype=torch.int64, device=cand.device)
    rho = cand.new_empty((B,))
    lib = _build.load("gnep_iter", _SIGNATURES)
    fn = getattr(lib, f"{what}_{_SUFFIX[dt]}")
    err = fn(*(t.data_ptr() for t in args), fill_best.data_ptr(),
             obj.data_ptr(), best.data_ptr(), rho.data_ptr(), B, Nc, N,
             _build.stream_of(cand))
    _build.check(lib, err, what)
    fused_iter_sweep.launches += 1
    return fill_best, obj, best, rho


fused_iter_sweep.launches = 0
