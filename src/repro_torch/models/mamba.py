"""Mamba (S6) selective-state-space mixer, as used by Jamba (arXiv:2403.19887).

Counterpart of ``repro.models.mamba``.  Selective scan:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t,    y_t = <C_t, h_t> + D x_t

with a per-channel diagonal A (d_in, N); Jamba's dt / B / C RMS norms are
included.  ``_ssm_scan_chunked`` runs a log-depth doubling (Hillis-Steele)
scan *within* each chunk of ``chunk`` steps and carries h *across* chunks,
as the reference does with ``associative_scan`` inside ``lax.scan``; the
two reorder only the products and sums of the same recurrence.  The
reference's ``loops`` switch (scan or unrolled, for XLA's cost analysis)
has no counterpart: PyTorch runs one eager computation.

The chunked form is exact: a chunk's cumulative decays are products, never
quotients, so no step divides by a decay that has underflowed (dt A reaches
about -1.6 a step, and 64 such steps pass below f32's smallest normal).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers

F32 = torch.float32


def mamba_init(cfg, gen):
    """Random parameters on ``gen``'s device, equal to JAX in distribution
    only.  ``A_log``, ``D`` and ``dt_bias`` are f32 whatever
    ``cfg.param_dtype``, as in the reference."""
    mc = cfg.mamba
    d = cfg.d_model
    d_in = mc.expand * d
    R = mc.rank(d)
    N = mc.d_state
    pd = cfg.pdtype
    dev = gen.device
    A = torch.arange(1, N + 1, dtype=F32, device=dev)[None].repeat(d_in, 1)
    lo, hi = math.log(0.001), math.log(0.1)
    dt = torch.exp(layers.uniform(gen, (d_in,), hi - lo) + lo)
    return {
        "in_proj": layers.dense_init(gen, d, 2 * d_in, pd),
        "conv_w": (layers.normal(gen, (mc.d_conv, d_in), 1.0 / mc.d_conv)
                   .to(pd)),
        "conv_b": torch.zeros((d_in,), dtype=pd, device=dev),
        "x_proj": layers.dense_init(gen, d_in, R + 2 * N, pd),
        "dt_w": layers.dense_init(gen, R, d_in, pd, scale=R ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(A),
        "D": torch.ones((d_in,), dtype=F32, device=dev),
        "out_proj": layers.dense_init(gen, d_in, d, pd),
        "dt_norm": torch.zeros((R,), dtype=pd, device=dev),
        "b_norm": torch.zeros((N,), dtype=pd, device=dev),
        "c_norm": torch.zeros((N,), dtype=pd, device=dev),
    }


def _scan_chunk(dc, ic):
    """Inclusive scan over axis 1 of the affine maps h -> dc h + ic under
    the reference's ``combine(a, b) = (a_d b_d, a_i b_d + b_i)`` (a before
    b), by doubling: log2(chunk) steps."""
    n, off = dc.shape[1], 1
    while off < n:
        ic = torch.cat([ic[:, :off], ic[:, :-off] * dc[:, off:] + ic[:, off:]],
                       dim=1)
        dc = torch.cat([dc[:, :off], dc[:, :-off] * dc[:, off:]], dim=1)
        off *= 2
    return dc, ic


def _ssm_scan_chunked(decay, inc, h0, *, chunk):
    """h_t = decay_t * h_{t-1} + inc_t over axis 1.  (B,T,d_in,N) f32.

    Returns every step's h (B,T,d_in,N) and the last one (B,d_in,N)."""
    B, T, d_in, N = decay.shape
    chunk = min(chunk, T)
    if T % chunk:
        raise ValueError(f"chunk {chunk} does not divide T = {T}")
    n = T // chunk
    dec = decay.reshape(B, n, chunk, d_in, N)
    inc = inc.reshape(B, n, chunk, d_in, N)
    ys = torch.empty_like(dec)
    h = h0
    for ci in range(n):
        cum_d, cum_i = _scan_chunk(dec[:, ci], inc[:, ci])
        ys[:, ci] = cum_d * h[:, None] + cum_i
        h = ys[:, ci, -1]
    # a copy, so that a cache holding h does not hold every step's h
    return ys.reshape(B, T, d_in, N), h.clone()


def _causal_conv(x, w, b, tail):
    """Depthwise causal conv1d by shifted adds in f32.  x: (B,T,d_in);
    w: (dc,d_in); tail: (B, dc-1, d_in) history (zeros at sequence start).
    Returns the output and the new tail, both in x's dtype."""
    dc, T = w.shape[0], x.shape[1]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = xp[:, :T].to(F32) * w[0].to(F32)     # the reference adds to zeros
    for j in range(1, dc):
        out = out + xp[:, j:j + T].to(F32) * w[j].to(F32)
    out = out + b.to(F32)
    return out.to(x.dtype), xp[:, -(dc - 1):].clone()


def mamba_mixer(cfg, p, x, state, *, chunk=64):
    """x: (B,T,d). state: {"h": (B,d_in,N) f32, "conv": (B,dc-1,d_in)} or
    None (zeros).  Returns (out (B,T,d) in x's dtype, new state)."""
    mc = cfg.mamba
    B, T, d = x.shape
    d_in = mc.expand * d
    N = mc.d_state
    R = mc.rank(d)
    if state is None:
        state = {"h": torch.zeros((B, d_in, N), dtype=F32, device=x.device),
                 "conv": torch.zeros((B, mc.d_conv - 1, d_in), dtype=x.dtype,
                                     device=x.device)}

    xz = layers.dot(x, p["in_proj"]).to(x.dtype)
    xi, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_tail = _causal_conv(xi, p["conv_w"], p["conv_b"], state["conv"])
    xc = F.silu(xc.to(F32)).to(x.dtype)

    proj = layers.dot(xc, p["x_proj"])                    # (B,T,R+2N) f32
    dt_low, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
    dt_low = layers.rmsnorm(dt_low, p["dt_norm"])
    Bc = layers.rmsnorm(Bc, p["b_norm"]).to(F32)
    Cc = layers.rmsnorm(Cc, p["c_norm"]).to(F32)
    # dt_low is f32, so dt_w is promoted and the product is an f32 matmul
    dt = F.softplus(layers.dot(dt_low, p["dt_w"])
                    + p["dt_bias"].to(F32))                # (B,T,d_in) f32

    A = -torch.exp(p["A_log"])                             # (d_in,N)
    decay = torch.exp(dt[..., None] * A)                   # (B,T,d_in,N)
    inc = (dt * xc.to(F32))[..., None] * Bc[:, :, None, :]

    h_all, h_last = _ssm_scan_chunked(decay, inc, state["h"], chunk=chunk)
    del decay, inc           # two (B,T,d_in,N) f32 tensors: lower the peak
    y = torch.einsum("btdn,btn->btd", h_all, Cc)           # f32
    y = y + p["D"].to(F32) * xc.to(F32)
    y = (y * F.silu(z.to(F32))).to(x.dtype)
    out = layers.dot(y, p["out_proj"]).to(x.dtype)
    return out, {"h": h_last, "conv": conv_tail}
