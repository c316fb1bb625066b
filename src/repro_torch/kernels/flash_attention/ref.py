"""Plain PyTorch versions of the flash-attention kernels (O(S^2) memory).

Counterpart of ``repro.kernels.flash_attention.ref``: a thin call into the
model's dense ``reference``.  The kernel wrapper returns it for CPU
tensors, and ``chip_smoke.py`` holds the CUDA kernel to it on the card.

``forward_lse`` and ``backward`` are the plain versions of the kernel's
forward with its per-row logsumexp and of its backward kernels
(``csrc/flash_attention_bwd.cu``), written out as the kernels compute them.
The tests and ``chip_smoke.py`` hold the kernels to them; nothing on the
card's path calls them.
"""
import torch

from repro_torch.models import attention as _attention

F32 = torch.float32


def reference(q, k, v, *, causal=True):
    """q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd)."""
    return _attention.reference(q, k, v, causal=causal)


def _scores(q, k, causal):
    """The scaled, masked f32 scores (B, Hkv, G, Sq, Skv): -1e30 above the
    causal diagonal, as ``reference`` masks them."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    qf = q.to(F32).reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(F32)) * hd ** -0.5
    if causal:
        keep = (torch.arange(Skv, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(keep, s, _attention.NEG_INF)
    return s


def forward_lse(q, k, v, *, causal=True):
    """(o in q's dtype, lse (B, Hq, Sq) f32): ``reference``'s output and the
    logsumexp of each row's scaled, masked scores."""
    B, Sq, Hq, hd = q.shape
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)                       # (B,Hkv,G,Sq)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(F32))
    return o.reshape(B, Sq, Hq, hd).to(q.dtype), lse.reshape(B, Hq, Sq)


def backward(q, k, v, o, lse, do, *, causal=True):
    """(dq, dk, dv) in the operands' dtypes from the forward's output ``o``,
    its ``lse`` (B, Hq, Sq) and the output's cotangent ``do``, in f32:

        D = rowsum(dO o),  P = exp(S - lse),  dV = P^T dO,
        dS = P (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q,

    dK and dV summed over the ``Hq / Hkv`` query heads of each kv head."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = hd ** -0.5
    grp = lambda x: x.to(F32).reshape(B, Sq, Hkv, G, hd)
    qf, of, dof = grp(q), grp(o), grp(do)
    kf, vf = k.to(F32), v.to(F32)
    D = torch.einsum("bqhgd,bqhgd->bhgq", dof, of)
    p = torch.exp(_scores(q, k, causal)
                  - lse.to(F32).reshape(B, Hkv, G, Sq)[..., None])
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - D[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
