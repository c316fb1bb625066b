"""Decoder-only LM: the dense (GQA + qk-norm + RoPE), MoE and RWKV6 families.

Counterpart of the decoder-only subset of ``repro.models.transformer``.
Parameters are plain dicts of tensors; JAX's ``lax.scan`` over vmapped
"blocks" becomes a loop over ``params["layers"]``, one dict per layer, with
the MoE families' ``first_k_dense`` head layers first
(``repro_torch.convert.lm_params_from_numpy`` turns a JAX pytree into this
form; caches follow the same flat order).  There is no ``Distribution``:
tensor parallelism, sequence sharding and expert parallelism wait for
``models/sharding.py`` (ROADMAP Queue 1 item 20).

Families not ported yet raise ``NotImplementedError`` naming their ROADMAP
Queue 1 item: Mamba and the hybrid interleave (16, Jamba included),
enc-dec (17) and the VLM's M-RoPE (18).  ``loss_fn`` and activation
rematerialisation belong to the training path (19); the port runs
inference only, where ``cfg.remat`` changes nothing.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import ModelConfig
from repro_torch.utils import resolve_device

_NOT_PORTED = (
    (lambda c: c.mamba is not None, "Mamba and hybrid mixers", 16),
    (lambda c: c.is_encdec, "the encoder-decoder family", 17),
    (lambda c: bool(c.mrope_sections), "the VLM's M-RoPE", 18),
)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port has no path for."""
    for test, what, item in _NOT_PORTED:
        if test(cfg):
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported to repro_torch yet "
                f"(ROADMAP.md Queue 1 item {item})")


# ==========================================================================
# init: draws on the generator's device, equal to JAX in distribution only
# ==========================================================================

def _attn_init(cfg, gen):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {
        "wq": layers.dense_init(gen, d, hq * hd, cfg.pdtype),
        "wk": layers.dense_init(gen, d, hkv * hd, cfg.pdtype),
        "wv": layers.dense_init(gen, d, hkv * hd, cfg.pdtype),
        "wo": layers.dense_init(gen, hq * hd, d, cfg.pdtype,
                                scale=(hq * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=cfg.pdtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=cfg.pdtype, device=gen.device)
    return p


def _layer_init(cfg, gen, mixer_kind, ffn_kind):
    dev = gen.device
    p: Dict[str, Any] = {"norm1": layers.norm_init(cfg, device=dev),
                         "norm2": layers.norm_init(cfg, device=dev)}
    if mixer_kind == "attn":
        p["mixer"] = _attn_init(cfg, gen)
    elif mixer_kind == "rwkv":
        p["mixer"] = rwkv_mod.time_mix_init(cfg, gen)
    else:
        raise ValueError(mixer_kind)
    if ffn_kind == "dense":
        p["ffn"] = layers.mlp_init(cfg, gen)
    elif ffn_kind == "moe":
        p["ffn"] = moe_mod.moe_init(cfg, gen)
    elif ffn_kind == "rwkv_cmix":
        p["ffn"] = rwkv_mod.channel_mix_init(cfg, gen)
    else:
        raise ValueError(ffn_kind)
    return p


def init_params(cfg: ModelConfig, gen, *, device="cuda") -> Dict[str, Any]:
    """Random parameters, drawn on ``device`` (default the card).

    ``gen`` is an int seed or a ``torch.Generator`` on ``device``.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    elif gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters asked on "
                         f"{dev}")
    params: Dict[str, Any] = {"embed": layers.embed_init(
        gen, cfg.vocab, cfg.d_model, cfg.pdtype)}
    if cfg.max_positions:
        params["pos_embed"] = layers.normal(
            gen, (cfg.max_positions, cfg.d_model), 0.01).to(cfg.pdtype)
    params["layers"] = [_layer_init(cfg, gen, *kinds)
                        for kinds in cfg.layer_kinds()]
    params["final_norm"] = layers.norm_init(cfg, device=gen.device)
    if not cfg.tie_embeddings:
        params["unembed_w"] = layers.dense_init(gen, cfg.d_model, cfg.vocab,
                                                cfg.pdtype)
    return params


# ==========================================================================
# mixers and one layer
# ==========================================================================

def _attn_mixer(cfg, p, x, positions, *, causal=True, loops="scan",
                cache=None, cache_pos=None, collect=False):
    B, S, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = layers.dot(x, p["wq"]).to(x.dtype).reshape(B, S, hq, hd)
    k = layers.dot(x, p["wk"]).to(x.dtype).reshape(B, S, hkv, hd)
    v = layers.dot(x, p["wv"]).to(x.dtype).reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k = layers.rmsnorm(k, p["k_norm"], cfg.rms_eps)
    if not cfg.max_positions:                           # rotary models
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:                               # decode (S == 1)
        # JAX donates the cache to dynamic_update_slice; here the slot is
        # written in place, so the caller's cache tensors change.
        cache["k"][:, cache_pos:cache_pos + S] = k
        cache["v"][:, cache_pos:cache_pos + S] = v
        o = attn_mod.decode_attention(q, cache["k"], cache["v"],
                                      kv_len=cache_pos + 1)
        new_cache = cache
    else:
        o = attn_mod.attention(
            q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk, loops=loops,
            triangle=cfg.attn_triangle and causal)
        if collect:
            new_cache = {"k": k, "v": v}
    out = layers.dot(o.reshape(B, S, hq * hd), p["wo"]).to(x.dtype)
    return out, new_cache


def _apply_layer(cfg, p, h, kinds, ctx, cache=None):
    """Returns (h, aux, new_cache); aux is the MoE layer's load-balance
    loss, None for the other FFNs (JAX's f32 zero, which would cost a
    kernel launch a layer here)."""
    mixer_kind, ffn_kind = kinds
    new_cache: Dict[str, Any] = {}
    keep = ctx["collect"] or cache is not None

    hn = layers.apply_norm(cfg, p["norm1"], h)
    if mixer_kind == "attn":
        mo, c = _attn_mixer(
            cfg, p["mixer"], hn, ctx["positions"], causal=ctx["causal"],
            loops=ctx["loops"], cache=None if cache is None else cache["attn"],
            cache_pos=ctx.get("cache_pos"), collect=ctx["collect"])
        if c is not None:
            new_cache["attn"] = c
    elif mixer_kind == "rwkv":
        st = None if cache is None else cache["rwkv"]
        T = hn.shape[1]
        chunk = math.gcd(T, max(256, T // 128))   # as the JAX model picks it
        mo, st2 = rwkv_mod.time_mix(cfg, p["mixer"], hn, st, chunk=chunk)
        if keep:
            new_cache["rwkv"] = st2
    else:
        raise ValueError(mixer_kind)
    h = h + mo

    hn = layers.apply_norm(cfg, p["norm2"], h)
    aux = None
    if ffn_kind == "dense":
        fo = layers.mlp_apply(cfg, p["ffn"], hn)
    elif ffn_kind == "moe":
        gates, idx, aux = moe_mod.route(cfg, p["ffn"], hn)
        fo = moe_mod.moe_apply(cfg, p["ffn"], hn, gates, idx)
    elif ffn_kind == "rwkv_cmix":
        st = None if cache is None else cache["cshift"]
        fo, st2 = rwkv_mod.channel_mix(cfg, p["ffn"], hn, st)
        if keep:
            new_cache["cshift"] = st2
    else:
        raise ValueError(ffn_kind)
    return h + fo, aux, new_cache


# ==========================================================================
# forward / prefill / decode
# ==========================================================================

def _embed_in(cfg, params, batch):
    if "embeds" in batch:
        h = batch["embeds"].to(cfg.adtype)
    else:
        h = params["embed"][batch["tokens"]].to(cfg.adtype)
    if cfg.max_positions:
        S = h.shape[1]
        h = h + params["pos_embed"][:S][None].to(cfg.adtype)
    return h


def backbone(cfg: ModelConfig, params, batch, *, loops: str = "scan",
             collect: bool = False):
    """Runs everything up to (and incl.) the final norm.
    Returns (h, aux, caches): aux sums the MoE layers' load-balance losses
    in layer order (f32 zero without MoE layers); caches is
    ``{"layers": [...]}`` or None."""
    check_supported(cfg)
    h = _embed_in(cfg, params, batch)
    ctx = {"loops": loops, "collect": collect, "causal": True,
           "positions": torch.arange(h.shape[1], device=h.device)[None, :]}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    for p, kinds in zip(params["layers"], cfg.layer_kinds()):
        h, a, c = _apply_layer(cfg, p, h, kinds, ctx)
        if a is not None:
            aux = aux + a
        caches.append(c)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return h, aux, ({"layers": caches} if collect else None)


def _unembed(cfg, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed_w"]
    logits = layers.dot(h, w)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward(cfg: ModelConfig, params, batch, *, loops: str = "scan",
            collect: bool = False):
    """Teacher-forcing forward.  Returns (logits f32, aux, caches)."""
    h, aux, caches = backbone(cfg, params, batch, loops=loops,
                              collect=collect)
    return _unembed(cfg, params, h), aux, caches


def loss_fn(cfg, params, batch, *, loops: str = "scan", aux_coef=0.01):
    raise NotImplementedError("loss_fn and the training path are not ported "
                              "to repro_torch yet (ROADMAP.md Queue 1 item "
                              "19)")


def _layer_cache_init(cfg, kinds, B, max_len, dtype, dev):
    mixer_kind, ffn_kind = kinds
    d = cfg.d_model
    c: Dict[str, Any] = {}
    if mixer_kind == "attn":
        shape = (B, max_len, cfg.n_kv, cfg.hd)
        c["attn"] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}
    elif mixer_kind == "rwkv":
        hd = cfg.rwkv_head_dim
        c["rwkv"] = {"S": torch.zeros((B, d // hd, hd, hd),
                                      dtype=torch.float32, device=dev),
                     "shift": torch.zeros((B, d), dtype=dtype, device=dev)}
    if ffn_kind == "rwkv_cmix":
        c["cshift"] = torch.zeros((B, d), dtype=dtype, device=dev)
    return c


def init_cache(cfg, B, max_len, *, device="cuda"):
    """Zero caches for ``B`` sequences of up to ``max_len`` positions."""
    check_supported(cfg)
    dev = resolve_device(device)
    return {"layers": [_layer_cache_init(cfg, kinds, B, max_len, cfg.adtype,
                                         dev)
                       for kinds in cfg.layer_kinds()]}


def prefill(cfg, params, batch, *, loops: str = "scan"):
    """Full-sequence forward that also returns the cache (kv/state)."""
    logits, _, caches = forward(cfg, params, batch, loops=loops, collect=True)
    return logits[:, -1:], caches


def decode_step(cfg, params, cache, token, pos):
    """One decode step.  token: (B,) integers; pos: int (the write slot).

    Returns (logits (B,1,V), new_cache).  Attention caches are written in
    place at ``pos`` (see ``_attn_mixer``).
    """
    check_supported(cfg)
    pos = int(pos)
    h = params["embed"][token][:, None].to(cfg.adtype)       # (B,1,d)
    if cfg.max_positions:
        h = h + params["pos_embed"][pos][None, None].to(cfg.adtype)
    ctx = {"loops": "scan", "collect": False, "causal": True,
           "positions": torch.full((1, 1), pos, device=h.device),
           "cache_pos": pos}
    new_layers = []
    for p, kinds, c in zip(params["layers"], cfg.layer_kinds(),
                           cache["layers"]):
        h, _, nc = _apply_layer(cfg, p, h, kinds, ctx, cache=c)
        new_layers.append(nc)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return _unembed(cfg, params, h), {"layers": new_layers}
