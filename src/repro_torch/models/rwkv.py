"""RWKV-6 "Finch" blocks (arXiv:2404.05892): data-dependent-decay linear
attention (time-mix) + squared-ReLU channel-mix.

Counterpart of ``repro.models.rwkv``.  Three evaluation paths:

* ``wkv_recurrent`` -- exact per-step recurrence; the oracle.
* ``wkv_chunked``   -- chunk-parallel form with cumulative-decay factors
  (log-space, exponents clamped at +-30), inter-chunk state carry.  It is
  the plain version of the ``wkv6`` kernel.
* ``wkv_step``      -- single decode step.

``time_mix`` dispatches as JAX's does by length: ``T == 1`` ->
``wkv_step``; ``2 <= T <= chunk`` -> the ``wkv6`` kernel wrapper at chunk 1,
whose chunked form is the recurrence's function (JAX runs
``wkv_recurrent`` there, one ``lax.scan`` that XLA compiles into one device
loop; a Python loop here would launch every step's kernels from the
host); longer -> the wrapper at ``chunk``.  The wrapper launches the CUDA
kernels for CUDA tensors and runs ``wkv_chunked`` for CPU tensors.

State per layer: S (B,H,K,V) + token-shift tails for time/channel mix.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6 import kernel as _wkv_kernel
from repro_torch.models import layers

TM_LORA = 32
DECAY_LORA = 64
CLAMP = 30.0
F32 = torch.float32


# --------------------------------------------------------------------------
# init: draws on ``gen``'s device, equal to JAX in distribution only
# --------------------------------------------------------------------------

def time_mix_init(cfg, gen):
    d = cfg.d_model
    H = d // cfg.rwkv_head_dim
    hd = cfg.rwkv_head_dim
    pd = cfg.pdtype

    def vec(scale=0.5):
        return layers.uniform(gen, (d,), scale).to(pd)

    p = {f"mu_{n}": vec() for n in ("x", "w", "k", "v", "r", "g")}
    p.update({
        "tm_lora_a": layers.dense_init(gen, d, 5 * TM_LORA, pd, scale=0.01),
        "tm_lora_b": layers.normal(gen, (5, TM_LORA, d), 0.01).to(pd),
        "w0": layers.normal(gen, (d,), 0.3, -0.6),
        "wA": layers.dense_init(gen, d, DECAY_LORA, pd, scale=0.01),
        "wB": layers.dense_init(gen, DECAY_LORA, d, pd, scale=0.01),
        "u": layers.normal(gen, (H, hd), 0.3),
        "rwkv_wr": layers.dense_init(gen, d, d, pd),
        "rwkv_wk": layers.dense_init(gen, d, d, pd),
        "rwkv_wv": layers.dense_init(gen, d, d, pd),
        "rwkv_wg": layers.dense_init(gen, d, d, pd),
        "rwkv_wo": layers.dense_init(gen, d, d, pd),
        "gn_gamma": torch.ones((d,), dtype=pd, device=gen.device),
        "gn_beta": torch.zeros((d,), dtype=pd, device=gen.device),
    })
    return p


def channel_mix_init(cfg, gen):
    d, f = cfg.d_model, cfg.d_ff
    pd = cfg.pdtype
    return {
        "mu_ck": layers.uniform(gen, (d,), 0.5).to(pd),
        "mu_cr": layers.uniform(gen, (d,), 0.5).to(pd),
        "wu": layers.dense_init(gen, d, f, pd),
        "wd": layers.dense_init(gen, f, d, pd),
        "rwkv_wr_c": layers.dense_init(gen, d, d, pd),
    }


# --------------------------------------------------------------------------
# WKV core
# --------------------------------------------------------------------------

def wkv_step(r, k, v, w_log, u, S):
    """Single decode step. r/k/v/w_log: (B,H,K); S: (B,H,K,V)."""
    y = torch.einsum("bhk,bhkv->bhv", r,
                     S + u[None, :, :, None] * k[..., None] * v[..., None, :])
    S = torch.exp(w_log)[..., None] * S + k[..., None] * v[..., None, :]
    return y, S


def wkv_recurrent(r, k, v, w_log, u, S0):
    """Oracle recurrence.  r/k/v/w_log: (B,T,H,K); u: (H,K); S0: (B,H,K,V)."""
    S, ys = S0, []
    for t in range(r.shape[1]):
        y, S = wkv_step(r[:, t], k[:, t], v[:, t], w_log[:, t], u, S)
        ys.append(y)
    return torch.stack(ys, dim=1), S              # (B,T,H,V), state


def wkv_chunked(r, k, v, w_log, u, S0, *, chunk=64):
    """Chunk-parallel WKV.  Shapes as in wkv_recurrent."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    if T % chunk:
        raise ValueError(f"T={T} must be divisible by chunk={chunk}")
    n = T // chunk

    def resh(x):
        return x.reshape(B, n, chunk, H, x.shape[-1]).transpose(2, 3)

    r_, k_, v_, w_ = map(resh, (r, k, v, w_log))            # (B,n,H,L,K)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    S = S0.to(F32)
    ys = []
    for ci in range(n):
        rc, kc, vc, wc = (x[:, ci].to(F32) for x in (r_, k_, v_, w_))
        LW = torch.cumsum(wc, dim=2)                      # LW_t = sum_{1..t}
        LWp = LW - wc                                     # LW_{t-1}
        Z = LW[:, :, chunk // 2][:, :, None, :]           # per-channel ref
        Q = rc * torch.exp(torch.clamp(LWp - Z, -CLAMP, CLAMP))
        Kf = kc * torch.exp(torch.clamp(Z - LW, -CLAMP, CLAMP))
        A = torch.einsum("bhlk,bhmk->bhlm", Q, Kf)
        A = torch.where(causal[None, None], A, 0.0)
        diag = torch.einsum("bhlk,hk,bhlk->bhl", rc, u, kc)
        inter = torch.einsum("bhlk,bhkv->bhlv", rc * torch.exp(LWp), S)
        y = (torch.einsum("bhlm,bhmv->bhlv", A, vc)
             + diag[..., None] * vc + inter)              # (B,H,L,V)
        LW_end = LW[:, :, -1]                             # (B,H,K)
        K2 = kc * torch.exp(LW_end[:, :, None, :] - LW)   # exponent <= 0
        S = (torch.exp(LW_end)[..., None] * S
             + torch.einsum("bhlk,bhlv->bhkv", K2, vc))
        ys.append(y)
    out = torch.stack(ys, dim=1)                          # (B,n,H,L,V)
    out = out.transpose(2, 3).reshape(B, T, H, V)
    return out.to(r.dtype), S


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _ddlerp(p, x, sx):
    """Data-dependent token-shift interpolation (the RWKV6 'ddlerp')."""
    xx = sx - x
    xxx = x + xx * p["mu_x"].to(x.dtype)
    lo = torch.tanh(layers.dot(xxx, p["tm_lora_a"]))     # (B,T,5*32) f32
    lo = lo.reshape(*lo.shape[:-1], 5, TM_LORA)
    mods = torch.einsum("btsk,skd->sbtd", lo,
                        p["tm_lora_b"].to(F32))           # (5,B,T,d) f32
    outs = []
    for i, mu in enumerate(("mu_w", "mu_k", "mu_v", "mu_r", "mu_g")):
        mix = p[mu].to(F32) + mods[i]
        outs.append((x.to(F32) + xx.to(F32) * mix).to(x.dtype))
    return outs                                           # xw, xk, xv, xr, xg


def _group_norm(x, gamma, beta, H, eps=64e-5):
    """Per-head layer norm over the head channel (RWKV GroupNorm(H, d))."""
    B, T, d = x.shape
    xr = x.reshape(B, T, H, d // H).to(F32)
    mu = xr.mean(-1, keepdim=True)
    var = xr.var(-1, keepdim=True, unbiased=False)
    xr = (xr - mu) * torch.rsqrt(var + eps)
    out = xr.reshape(B, T, d) * gamma.to(F32) + beta.to(F32)
    return out.to(x.dtype)


def time_mix(cfg, p, x, state, *, chunk=64):
    """x: (B,T,d); state: {"S": (B,H,K,V), "shift": (B,d)} or None."""
    B, T, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    if state is None:
        state = {"S": torch.zeros((B, H, hd, hd), dtype=F32, device=x.device),
                 "shift": torch.zeros((B, d), dtype=x.dtype, device=x.device)}
    sx = torch.cat([state["shift"][:, None], x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)

    def heads(z, w):
        return layers.dot(z, w).to(x.dtype).reshape(B, T, H, hd)

    r = heads(xr, p["rwkv_wr"])
    kk = heads(xk, p["rwkv_wk"])
    v = heads(xv, p["rwkv_wv"])
    g = layers.dot(xg, p["rwkv_wg"])
    w_log = -torch.exp(p["w0"].to(F32)
                       + layers.dot(torch.tanh(layers.dot(xw, p["wA"])),
                                    p["wB"]))
    w_log = torch.clamp(w_log, -8.0, -1e-5).reshape(B, T, H, hd)

    u = p["u"].to(F32)
    if T == 1:
        y, S = wkv_step(r[:, 0].to(F32), kk[:, 0].to(F32), v[:, 0].to(F32),
                        w_log[:, 0], u, state["S"])
        y = y[:, None]
    elif T <= chunk:
        # the chunked form at chunk 1 is the recurrence: one row a chunk
        # has no pair in A, and LWp = LW_end - LW = 0, so no clip acts;
        # only f32 rounding departs from wkv_recurrent
        y, S = _wkv_kernel.wkv6(r.to(F32), kk.to(F32), v.to(F32), w_log, u,
                                chunk=1, S0=state["S"].to(F32))
    else:
        y, S = _wkv_kernel.wkv6(r.to(F32), kk.to(F32), v.to(F32), w_log, u,
                                chunk=chunk, S0=state["S"].to(F32))
    y = y.reshape(B, T, d).to(x.dtype)
    y = _group_norm(y, p["gn_gamma"], p["gn_beta"], H)
    y = y * F.silu(g).to(x.dtype)
    out = layers.dot(y, p["rwkv_wo"]).to(x.dtype)
    new_state = {"S": S, "shift": x[:, -1]}
    return out, new_state


def channel_mix(cfg, p, x, shift_state):
    """Squared-ReLU channel mix. shift_state: (B,d) or None."""
    if shift_state is None:
        shift_state = torch.zeros((x.shape[0], x.shape[-1]), dtype=x.dtype,
                                  device=x.device)
    sx = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
    xx = sx - x
    xk = x + xx * p["mu_ck"].to(x.dtype)
    xr = x + xx * p["mu_cr"].to(x.dtype)
    kk = torch.square(F.relu(layers.dot(xk, p["wu"]))).to(x.dtype)
    out = torch.sigmoid(layers.dot(xr, p["rwkv_wr_c"])).to(x.dtype) \
        * layers.dot(kk, p["wd"]).to(x.dtype)
    return out, x[:, -1]
