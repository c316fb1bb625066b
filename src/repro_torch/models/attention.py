"""GQA softmax attention (counterpart of ``repro.models.attention``).

``attention`` dispatches on the device of its tensors:

* a CUDA tensor, in self-attention with ``q_offset == 0`` and no
  ``kv_len`` (prefill and teacher-forced forward, causal or not), goes to
  the hand-written ``flash_attention`` kernel (``csrc/flash_attention.cu``)
  at every shape; the kernel masks ragged edges itself.  A meta tensor
  (the dry run's stand-in for the card) takes the same route, to the
  kernel's operator, which launches nothing on meta;
* anything else follows the JAX dispatch: the dense ``reference`` when
  ``Sq * Skv <= q_chunk * kv_chunk`` or the shape is not chunk-divisible,
  else the chunked online softmax (``scan``, ``unroll`` and ``triangle``
  are one computation here: PyTorch runs eagerly, and ``triangle`` skips
  the kv chunks that are fully masked).

``decode_attention`` is the JAX function: the dense ``reference`` over the
cache, masked at ``kv_len``, or, with ``seq_sharded`` under a mesh, the
sequence-sharded form (f32 scores, masked max / exp / sum, then the
product with V): the same function, rounded differently.  Its sharding
constraints change no value (``models/sharding.py``).  No TPU kernel exists
for it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as _flash

NEG_INF = -1e30
F32 = torch.float32


def _mask(qpos, kpos, causal, kv_len):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    return mask


def reference(q, k, v, *, causal, q_offset=0, kv_len=None):
    """Dense O(S^2)-memory oracle (also the flash kernel's plain version)."""
    B, Sq, Hq, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qf = q.to(F32).reshape(B, Sq, Hkv, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(F32))
    s = s * dh ** -0.5
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = _mask(qpos, kpos, causal, kv_len)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(F32))
    return o.reshape(B, Sq, Hq, dh).to(q.dtype)


def _chunk_step(qc, kc, vc, m, l, acc, qpos, kpos, causal, kv_len, scale):
    """One (q-chunk x kv-chunk) flash update in f32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qc.to(F32), kc.to(F32)) * scale
    mask = _mask(qpos, kpos, causal, kv_len)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                               vc.to(F32))
    return m_new, l, acc


def attention(q, k, v, *, causal=True, q_offset=0, kv_len=None,
              q_chunk=1024, kv_chunk=1024, loops="scan", triangle=False):
    """GQA attention.  q: (B,Sq,Hq,dh); k,v: (B,Skv,Hkv,dh) -> (B,Sq,Hq,dh).

    ``kv_len``: valid-length mask for decode caches (int or 0-d tensor).
    """
    if (q.is_cuda or q.is_meta) and q_offset == 0 and kv_len is None:
        return _flash.flash_attention(q, k, v, causal=causal)
    B, Sq, Hq, dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = dh ** -0.5

    if triangle and not causal:
        raise ValueError("triangle blocking is causal-only")

    if loops == "dense" or (Sq * Skv <= q_chunk * kv_chunk):
        return reference(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        # the JAX model falls back to the dense oracle on odd sizes
        return reference(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len)
    nq, nk = Sq // q_chunk, Skv // kv_chunk

    qr = q.reshape(B, nq, q_chunk, Hkv, G, dh)
    kr = k.reshape(B, nk, kv_chunk, Hkv, dh)
    vr = v.reshape(B, nk, kv_chunk, Hkv, dh)
    outs = []
    for qi in range(nq):
        nk_visit = (min(nk, qi * q_chunk // kv_chunk + 1) if triangle
                    else nk)
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk,
                                                      device=q.device)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, dtype=F32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=F32, device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, dh), dtype=F32,
                          device=q.device)
        for ki in range(nk_visit):
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
            m, l, acc = _chunk_step(qr[:, qi], kr[:, ki], vr[:, ki], m, l,
                                    acc, qpos, kpos, causal, kv_len, scale)
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.stack(outs, dim=3)             # (B,Hkv,G,nq,q_chunk,dh)
    out = out.permute(0, 3, 4, 1, 2, 5)        # (B,nq,q_chunk,Hkv,G,dh)
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_len, dist=None,
                     seq_sharded=False):
    """Single-token decode: q (B,1,Hq,dh) vs cache (B,Smax,Hkv,dh).

    Dense over the cache, masked at ``kv_len``.  With ``seq_sharded`` (the
    cache sharded on S over the TP axis) under a mesh, the reference's
    distributed-flash form: its constraints pin XLA's schedule and change
    no value here, and its max / sum in f32 round as its own.
    """
    if not seq_sharded or dist is None or dist.tp is None:
        return reference(q, k_cache, v_cache, causal=False, kv_len=kv_len)
    B, Sq, Hq, dh = q.shape
    _, Skv, Hkv, _ = k_cache.shape
    G = Hq // Hkv
    qf = q.to(F32).reshape(B, Sq, Hkv, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                     k_cache.to(F32)) * dh ** -0.5
    s = dist.constrain(s, dist.dp_axes, None, None, None, dist.tp)
    kpos = torch.arange(Skv, device=q.device)
    s = torch.where((kpos < kv_len)[None, None, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = dist.constrain(p / l, dist.dp_axes, None, None, None, dist.tp)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v_cache.to(F32))
    o = dist.constrain(o.reshape(B, Sq, Hq, dh),
                       dist.dp_axes, None, None, None)
    return o.to(q.dtype)
