"""Mixture-of-Experts FFNs: top-k routing, capacity-bounded expert dispatch.

Counterpart of ``repro.models.moe``:

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

Expert parallelism (the reference's ``shard_map`` branch of ``moe_apply``)
under a mesh with a ``model`` axis of ``tp`` positions, laid out as
``models/sharding.py`` describes:

* the tokens are split over the data-parallel ranks when their count
  divides; otherwise every rank routes all of them, and one rank's result
  stands for all (they are the same);
* each rank's slice is dispatched with the capacity of its own token count
  and the global E, so pairs drop exactly as the reference drops them on
  that rank;
* each of the ``tp`` shards owns ``E / tp`` experts (``shard_id *
  E_loc`` on), the expert half of the reference's per-device
  ``_moe_body(n_shards, shard_id)``.  Under the layout every tensor lies
  whole on the tokens' device, so a rank's shards run there as one
  batched product over all its experts.  One product is what keeps
  ``tp`` from changing bits: cuBLAS picks its kernels by batch count (on
  an H100 the backward of four products of 16 experts at a capacity of 64
  does not round as that of one of 64), and the slot gather's backward
  adds a token's pairs within one call.  Running shards on other cards
  waits for collectives across cards (ROADMAP item 26);
* the shards' outputs fill the one slot buffer, and the combine above runs
  on it, so ``tp`` changes no bit and only the data-parallel split changes
  which pairs drop.  The reference instead ``psum``s per-shard partials in
  the activation dtype, so the port holds to it within that rounding.

The reference's FSDP all-gathers of the expert weights change no value and
have no counterpart: the weights are whole tensors.  ``LOCAL`` and a 1 x 1
mesh run the same computation, bit for bit.

``moe_dense_ref`` is the no-drop oracle used by the tests.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.sharding import LOCAL, Distribution

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

def _dispatch(cfg, idx, T):
    """Slots of T tokens' (T, k) expert choices: ``(tok_for_slot,
    slot_of_pair, cap)``; ``tok_for_slot`` (E*cap + 1,) holds each slot's
    token (0 for an empty slot, never gathered back; the last entry is the
    trash row), ``slot_of_pair`` (T*k,) each pair's slot in token-major
    order (``E*cap`` for a dropped pair)."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    dev = idx.device
    cap = capacity(cfg, T)
    trash = E * cap

    e_flat = idx.reshape(-1)                           # (T*k,) token-major
    tok_flat = torch.arange(T, device=dev).repeat_interleave(k)

    # position of each (token, expert) pair within its expert's queue
    sort_ix = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[sort_ix]
    # bincount's counts by a scatter-add, which meta tensors support
    counts = torch.zeros(E, dtype=e_flat.dtype, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=dev) - starts[e_sorted]
    slot = torch.where(pos < cap, e_sorted * cap + pos,
                       torch.full_like(pos, trash))

    tok_for_slot = torch.zeros(trash + 1, dtype=torch.long, device=dev)
    tok_for_slot[slot] = tok_flat[sort_ix]
    slot_of_pair = torch.empty_like(slot)
    slot_of_pair[sort_ix] = slot
    return tok_for_slot, slot_of_pair, cap


def _experts(cfg, experts, x, tok_for_slot, cap):
    """All E experts over their slots as one batched product.  Returns the
    outputs (E * cap, d) in the activation dtype."""
    E = cfg.moe.n_experts
    d = x.shape[1]
    x_g = x[tok_for_slot[:E * cap]].reshape(E, cap, d)
    g = layers.bmm(x_g, experts["wg"])
    u = layers.bmm(x_g, experts["wu"])
    h = (F.silu(g) * u).to(x.dtype)
    return layers.bmm(h, experts["wd"]).to(x.dtype).reshape(E * cap, d)


def _moe_body(cfg, experts, x, gates, idx):
    """Routed experts over tokens x: (T, d); gates / idx: (T, k).  Under a
    mesh, one data-parallel rank's body, its expert shards as one
    product."""
    k = cfg.moe.top_k
    T, d = x.shape
    dev = x.device
    tok_for_slot, slot_of_pair, cap = _dispatch(cfg, idx, T)
    trash = tok_for_slot.shape[0] - 1
    y = torch.cat([_experts(cfg, experts, x, tok_for_slot, cap),
                   x.new_zeros((1, d))])                     # the trash row

    kept = (slot_of_pair != trash).reshape(T, k)
    w = torch.where(kept, gates.reshape(T, k).to(F32),
                    torch.zeros((), dtype=F32, device=dev))
    y_pairs = y[slot_of_pair].reshape(T, k, d)
    out = torch.zeros((T, d), dtype=F32, device=dev)
    for j in range(k):                                       # fixed order
        out = out + y_pairs[:, j].to(F32) * w[:, j, None]
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

def moe_apply(cfg, p, x, gates, idx, dist: Distribution = LOCAL):
    """Routed-experts output (+ shared experts if configured).

    x: (B, S, d); gates / idx: (B, S, k).  Under a mesh with a ``model``
    axis, expert parallelism as the module docstring lays it out; without
    one, the single-device body.
    """
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    gf, idf = gates.reshape(B * S, -1), idx.reshape(B * S, -1)
    if dist.mesh is None or dist.tp is None:
        out = _moe_body(cfg, p["experts"], xf, gf, idf)
    else:
        # the data axes together, as the reference's shard_map splits the
        # tokens over them; an axis neither names is replicated
        dp_size = math.prod(dist.mesh.shape[a] for a in dist.dp_axes)
        n_shards = dist.mesh.shape[dist.tp]
        if cfg.moe.n_experts % n_shards:
            raise ValueError(f"{cfg.moe.n_experts} experts do not split "
                             f"over {n_shards} shards")
        # tokens split over dp when divisible (train / prefill); tiny decode
        # batches are routed redundantly on every dp rank instead
        n = B * S // dp_size if (B * S) % dp_size == 0 else B * S
        out = torch.cat([
            _moe_body(cfg, p["experts"], xf[r * n:(r + 1) * n],
                      gf[r * n:(r + 1) * n], idf[r * n:(r + 1) * n])
            for r in range(B * S // n)])
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
