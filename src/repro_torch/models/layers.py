"""Shared layers: norms, rotary embeddings, MLPs, embeddings.

Counterpart of ``repro.models.layers``.  Everything is a function over
explicit dicts of parameter tensors; ``bmm`` is the batched ``dot`` of the
MoE experts.  Norms, RoPE (``apply_rope``, and Qwen2-VL's ``apply_mrope``)
and the softmax run in f32, as in JAX.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

F32 = torch.float32


class _F32Product(torch.autograd.Function):
    """``torch.mm`` / ``torch.bmm`` of 16-bit card operands with an f32
    result (``out_dtype=torch.float32``), made differentiable: torch has no
    derivative for those overloads.  The cotangent stays f32: dA = dY . B^T
    and dB = A^T . dY are f32 products of it and the other operand cast to
    f32, returned in the operands' dtypes.  That is JAX's transpose of a
    dot with an f32 ``preferred_element_type``, and what autograd gives the
    CPU branch's f32 casts."""

    @staticmethod
    def forward(ctx, a, b, op):
        ctx.save_for_backward(a, b)
        ctx.op = op
        return op(a, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = ctx.op(g, b.to(F32).transpose(-2, -1)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = ctx.op(a.to(F32).transpose(-2, -1), g).to(b.dtype)
        return da, db, None


def dot(x, w):
    """``x @ w`` with an f32 result, as JAX's ``dot`` asks the matrix unit
    for one (``preferred_element_type``); mixed operand dtypes promote
    first, as ``jnp.matmul`` does.

    For 16-bit floats the product is never rounded to 16 bits: on the card
    ``torch.mm(..., out_dtype=torch.float32)`` sums in f32 and writes f32
    (differentiable through ``_F32Product``); on the CPU, which lacks that
    overload, both operands are cast to f32 first, which is what JAX's CPU
    backend computes.  ``w`` is 2-D.
    """
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if dt not in (torch.bfloat16, torch.float16):
        return torch.matmul(x, w).to(F32)
    if x.device.type == "cpu":
        return torch.matmul(x.to(F32), w.to(F32))
    out = _F32Product.apply(x.reshape(-1, x.shape[-1]), w, torch.mm)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def bmm(x, w):
    """Batched ``x @ w`` with an f32 result, as :func:`dot`: (n, a, b) .
    (n, b, c) -> (n, a, c), JAX's ``einsum(..., preferred_element_type=
    float32)`` over a leading batch axis.  On the card 16-bit operands go
    through ``torch.bmm(..., out_dtype=torch.float32)`` (differentiable
    through ``_F32Product``); on the CPU both are cast to f32 first."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if dt not in (torch.bfloat16, torch.float16):
        return torch.bmm(x, w).to(F32)
    if x.device.type == "cpu":
        return torch.bmm(x.to(F32), w.to(F32))
    return _F32Product.apply(x, w, torch.bmm)


# --------------------------------------------------------------------------
# init helpers: draws on ``gen``'s device; equal to JAX in distribution only
# --------------------------------------------------------------------------

class NoDraws:
    """Stands in for a ``torch.Generator`` where parameters are built on
    meta tensors (``init_params(cfg, None, device="meta")``, the counterpart
    of JAX's ``eval_shape``): :func:`normal` and :func:`uniform` then give
    f32 meta tensors of the shape and draw nothing."""
    device = torch.device("meta")


def normal(gen, shape, scale=1.0, shift=0.0):
    """f32 standard normal draws times ``scale`` plus ``shift``."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=F32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=F32) * scale + shift


def uniform(gen, shape, scale=1.0):
    """f32 uniform draws on [0, scale)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=F32, device="meta")
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=F32) * scale


def dense_init(gen, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return normal(gen, (d_in, d_out), scale).to(dtype)


def embed_init(gen, vocab, d, dtype):
    return normal(gen, (vocab, d), 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x, gamma, eps=1e-6):
    """RMS norm scaled by ``1 + gamma`` (gamma starts at zero), unlike
    ``torch.nn.RMSNorm``, which scales by ``gamma``."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.to(F32))).to(x.dtype)


def layernorm(x, gamma, beta, eps=1e-5):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.to(F32) + beta.to(F32)).to(x.dtype)


def norm_init(cfg, d=None, *, device):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"gamma": torch.zeros((d,), dtype=cfg.pdtype, device=device)}
    return {"gamma": torch.ones((d,), dtype=cfg.pdtype, device=device),
            "beta": torch.zeros((d,), dtype=cfg.pdtype, device=device)}


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["gamma"], cfg.rms_eps)
    return layernorm(x, p["gamma"], p["beta"])


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def _rope_freqs(hd_half, theta, device):
    return theta ** (-torch.arange(0, hd_half, dtype=F32, device=device)
                     / hd_half)


def _rotate(x, angles):
    """Rotate the two halves of x's last axis by ``angles`` (..., S, hd/2),
    broadcast over the head axis; in f32, returned in x's dtype."""
    angles = angles[..., None, :]                        # head axis
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: broadcastable to (..., S) integers."""
    freqs = _rope_freqs(x.shape[-1] // 2, theta, x.device)
    return _rotate(x, positions[..., None].to(F32) * freqs)


@functools.lru_cache(maxsize=None)
def _mrope_streams(sections, device):
    """The static band -> position-stream map: half-dim band j rotates by
    stream ``np.repeat(arange(len(sections)), sections)[j]``."""
    ids = torch.repeat_interleave(torch.arange(len(sections)),
                                  torch.tensor(sections))
    return ids.to(device)


def apply_mrope(x, positions3, theta, sections):
    """Qwen2-VL multimodal RoPE: the half-dim frequency bands are split into
    (temporal, height, width) sections, each rotated by its own position ids.

    x: (B, S, H, hd); positions3: (3, B, S) integers; sum(sections) ==
    hd // 2.  With three equal streams it is ``apply_rope`` bit for bit.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {sections} must cover hd/2 = "
                         f"{hd // 2}")
    freqs = _rope_freqs(hd // 2, theta, x.device)
    streams = _mrope_streams(tuple(sections), x.device)
    pos = positions3.to(F32).movedim(0, -1)[..., streams]   # (B,S,hd/2)
    return _rotate(x, pos * freqs)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_init(cfg, gen, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"wg": dense_init(gen, d, f, cfg.pdtype),
                "wu": dense_init(gen, d, f, cfg.pdtype),
                "wd": dense_init(gen, f, d, cfg.pdtype)}
    return {"wu": dense_init(gen, d, f, cfg.pdtype),
            "bu": torch.zeros((f,), dtype=cfg.pdtype, device=gen.device),
            "wd": dense_init(gen, f, d, cfg.pdtype),
            "bd": torch.zeros((d,), dtype=cfg.pdtype, device=gen.device)}


def mlp_apply(cfg, p, x):
    if cfg.act == "swiglu":
        g = dot(x, p["wg"])
        u = dot(x, p["wu"])
        h = (F.silu(g) * u).to(x.dtype)                  # f32 product, as JAX
        return dot(h, p["wd"]).to(x.dtype)
    h = dot(x, p["wu"]) + p["bu"].to(F32)
    h = F.gelu(h, approximate="tanh").to(x.dtype)        # jax.nn.gelu default
    return (dot(h, p["wd"]) + p["bd"].to(F32)).to(x.dtype)
