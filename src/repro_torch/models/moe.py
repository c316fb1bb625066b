"""Mixture-of-Experts FFNs: top-k routing, capacity-bounded expert dispatch.

Counterpart of ``repro.models.moe`` on one device (its ``n_shards=1`` body):

* routing is an f32 router (``layers.dot``), a softmax, top-k and, for
  DeepSeek-style configurations, renormalised gates; the Switch-style
  load-balance loss comes with it;
* per-expert capacity ``cap = max(8, ceil8(ceil(T*k*cf/E)))`` bounds the
  dispatch buffer.  Pairs are taken in token-major order, stably sorted by
  expert, and a pair whose position in its expert's queue is ``>= cap`` is
  dropped, exactly as the reference drops it (the reference's out-of-range
  scatter with ``mode="drop"`` writes to a trash row here, sliced off);
* the expert products are three batched products with f32 results
  (``layers.bmm``) over the (E, cap, d) buffer.

The combine differs in form, not in function: the reference scatter-adds
every slot's output into its token in the activation dtype, which on the
card is an atomic, order-free add.  Here each token gathers its k pair
outputs and sums them in f32 in the fixed order j = 0..k-1, then casts
once, so two runs give the same bits; empty slots and dropped pairs are
never gathered (the reference reads token 0 for an empty slot and relies on
its zero gate).

``torch.topk`` on CUDA need not break an exact tie between two experts'
probabilities towards the lower index, as ``lax.top_k`` does; with f32
probabilities of real-valued activations an exact tie is not expected.

The expert-parallel ``shard_map`` branch of the reference's ``moe_apply``
and its FSDP all-gathers wait for ``models/sharding.py`` (ROADMAP Queue 1
item 20); the port's ``moe_apply`` takes no ``Distribution``.

``moe_dense_ref`` is the no-drop oracle used by the tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

F32 = torch.float32


# --------------------------------------------------------------------------
# init: draws on the generator's device, equal to JAX in distribution only
# --------------------------------------------------------------------------

def moe_init(cfg, gen):
    mo = cfg.moe
    d, f, E = cfg.d_model, mo.d_ff_expert, mo.n_experts
    p = {
        "router": {"wr_router": layers.dense_init(gen, d, E, F32)},
        "experts": {
            "wg": _expert_init(gen, E, d, f, cfg.pdtype),
            "wu": _expert_init(gen, E, d, f, cfg.pdtype),
            "wd": _expert_init(gen, E, f, d, cfg.pdtype),
        },
    }
    if mo.n_shared:
        p["shared"] = layers.mlp_init(cfg, gen, d_ff=mo.n_shared * f)
    return p


def _expert_init(gen, E, d_in, d_out, dtype):
    return layers.normal(gen, (E, d_in, d_out), d_in ** -0.5).to(dtype)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

def route(cfg, p, x):
    """Top-k routing.  x: (B,S,d) -> gates (B,S,k) f32, idx (B,S,k) int64,
    aux (f32 scalar)."""
    mo = cfg.moe
    logits = layers.dot(x, p["router"]["wr_router"])        # (B,S,E) f32
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, mo.top_k, dim=-1)
    if mo.renorm_top_k:
        gates = gates / torch.sum(gates, dim=-1, keepdim=True)
    # Switch-style load-balance loss
    E = mo.n_experts
    me = torch.mean(probs.reshape(-1, E), dim=0)
    one_hot_top1 = F.one_hot(idx[..., 0].reshape(-1), E).to(F32)
    ce = torch.mean(one_hot_top1, dim=0)
    aux = (E * torch.sum(me * ce)).to(F32)
    return gates, idx, aux


def capacity(cfg, T: int) -> int:
    """Per-expert slots for ``T`` tokens: ``ceil(T*k*cf/E)`` rounded up to a
    multiple of 8, at least 8 (the reference's formula, float division
    included)."""
    mo = cfg.moe
    cap = int(-(-T * mo.top_k * mo.capacity_factor // mo.n_experts))
    return max(8, -(-cap // 8) * 8)


# --------------------------------------------------------------------------
# dispatch / compute / combine
# --------------------------------------------------------------------------

def _moe_body(cfg, experts, x, gates, idx):
    """Routed experts over tokens x: (T, d); gates / idx: (T, k)."""
    mo = cfg.moe
    E, k = mo.n_experts, mo.top_k
    T, d = x.shape
    dev = x.device
    cap = capacity(cfg, T)
    trash = E * cap

    e_flat = idx.reshape(-1)                           # (T*k,) token-major
    g_flat = gates.reshape(-1).to(F32)
    tok_flat = torch.arange(T, device=dev).repeat_interleave(k)

    # position of each (token, expert) pair within its expert's queue
    sort_ix = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[sort_ix]
    counts = torch.bincount(e_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[e_sorted]
    slot = torch.where(pos < cap, e_sorted * cap + pos,
                       torch.full_like(pos, trash))

    # slot -> token (empty slots read token 0, never gathered back), and
    # pair -> slot in token-major order (dropped pairs -> the trash row)
    tok_for_slot = torch.zeros(trash + 1, dtype=torch.long, device=dev)
    tok_for_slot[slot] = tok_flat[sort_ix]
    slot_of_pair = torch.empty_like(slot)
    slot_of_pair[sort_ix] = slot

    x_g = x[tok_for_slot[:trash]].reshape(E, cap, d)
    g = layers.bmm(x_g, experts["wg"])
    u = layers.bmm(x_g, experts["wu"])
    h = (F.silu(g) * u).to(x.dtype)
    y = layers.bmm(h, experts["wd"]).to(x.dtype).reshape(trash, d)
    y = torch.cat([y, y.new_zeros((1, d))])                  # the trash row

    kept = (slot_of_pair != trash).reshape(T, k)
    w = torch.where(kept, g_flat.reshape(T, k), torch.zeros((), dtype=F32,
                                                            device=dev))
    y_pairs = y[slot_of_pair].reshape(T, k, d)
    out = torch.zeros((T, d), dtype=F32, device=dev)
    for j in range(k):                                       # fixed order
        out = out + y_pairs[:, j].to(F32) * w[:, j, None]
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def moe_apply(cfg, p, x, gates, idx):
    """Routed-experts output (+ shared experts if configured).

    x: (B, S, d); gates / idx: (B, S, k).
    """
    B, S, d = x.shape
    out = _moe_body(cfg, p["experts"], x.reshape(B * S, d),
                    gates.reshape(B * S, -1), idx.reshape(B * S, -1))
    out = out.reshape(B, S, d)
    if cfg.moe.n_shared:
        out = out + layers.mlp_apply(cfg, p["shared"], x)
    return out


def moe_dense_ref(cfg, p, x, gates, idx):
    """No-drop oracle: every selected expert, in f32, summed over j = 0..k-1.

    Each expert runs once over the tokens that picked it (at any j), instead
    of the reference's per-token gather of expert weights (O(T*d*f) memory):
    the same function, its f32 sums in another order.
    """
    mo = cfg.moe
    B, S, d = x.shape
    xf = x.reshape(-1, d).to(F32)
    T, k = xf.shape[0], mo.top_k
    idf = idx.reshape(T, k)
    gf = gates.reshape(T, k).to(F32)
    ys = torch.zeros((T, k, d), dtype=F32, device=x.device)
    for e in range(mo.n_experts):
        tok, j = torch.nonzero(idf == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        a = xe @ p["experts"]["wg"][e].to(F32)
        b = xe @ p["experts"]["wu"][e].to(F32)
        ys[tok, j] = (F.silu(a) * b) @ p["experts"]["wd"][e].to(F32)
    out = torch.zeros((T, d), dtype=F32, device=x.device)
    for j in range(k):
        out = out + ys[:, j] * gf[:, j, None]
    out = out.to(x.dtype).reshape(B, S, d)
    if mo.n_shared:
        out = out + layers.mlp_apply(cfg, p["shared"], x)
    return out
