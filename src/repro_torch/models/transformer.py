"""Composable LM covering all 10 assigned architectures: GQA (+ qk-norm,
RoPE / Qwen2-VL's M-RoPE), dense and MoE FFNs, RWKV6, Mamba, Jamba's hybrid
interleave, and the Whisper encoder-decoder (audio front end stubbed).

Counterpart of ``repro.models.transformer``.  Parameters are plain dicts
of tensors; JAX's ``lax.scan`` over vmapped "blocks" of ``cfg.block_len``
layers becomes a loop over ``params["layers"]``, one dict per layer in
``cfg.layer_kinds()`` order, with the MoE families' ``first_k_dense`` head
layers first (Jamba's attention-at-offset-4 / MoE-on-odd-layers pattern
comes from the kinds alone).  The encoder-decoder keeps its encoder in
``params["enc_layers"]`` (JAX's ``enc_blocks``) and its decoder, each layer
with a ``"cross"`` attention and ``"norm_cross"``, in ``params["layers"]``
(JAX's ``dec_blocks``), so that ``decode_step``'s loop is shared.
``repro_torch.convert.lm_params_from_numpy`` turns a JAX pytree into this
form; caches follow the same flat order.  There is no ``Distribution``:
tensor parallelism, sequence sharding and expert parallelism wait for
``models/sharding.py`` (ROADMAP Queue 1 item 20).

``loss_fn`` and activation rematerialisation belong to the training path
(ROADMAP Queue 1 item 19); the port runs inference only, where
``cfg.remat`` changes nothing.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import ModelConfig
from repro_torch.utils import resolve_device


# ==========================================================================
# init: draws on the generator's device, equal to JAX in distribution only
# ==========================================================================

def _attn_init(cfg, gen, cross=False):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = {
        "wq": layers.dense_init(gen, d, hq * hd, cfg.pdtype),
        "wk": layers.dense_init(gen, d, hkv * hd, cfg.pdtype),
        "wv": layers.dense_init(gen, d, hkv * hd, cfg.pdtype),
        "wo": layers.dense_init(gen, hq * hd, d, cfg.pdtype,
                                scale=(hq * hd) ** -0.5),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.zeros((hd,), dtype=cfg.pdtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=cfg.pdtype, device=gen.device)
    return p


def _layer_init(cfg, gen, mixer_kind, ffn_kind, decoder_cross=False):
    dev = gen.device
    p: Dict[str, Any] = {"norm1": layers.norm_init(cfg, device=dev),
                         "norm2": layers.norm_init(cfg, device=dev)}
    if mixer_kind == "attn":
        p["mixer"] = _attn_init(cfg, gen)
    elif mixer_kind == "rwkv":
        p["mixer"] = rwkv_mod.time_mix_init(cfg, gen)
    elif mixer_kind == "mamba":
        p["mixer"] = mamba_mod.mamba_init(cfg, gen)
    else:
        raise ValueError(mixer_kind)
    if decoder_cross:
        p["cross"] = _attn_init(cfg, gen, cross=True)
        p["norm_cross"] = layers.norm_init(cfg, device=dev)
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
    if cfg.is_encdec:
        params["enc_layers"] = [_layer_init(cfg, gen, "attn", "dense")
                                for _ in range(cfg.encoder_layers)]
        params["layers"] = [_layer_init(cfg, gen, "attn", "dense",
                                        decoder_cross=True)
                            for _ in range(cfg.n_layers)]
        params["enc_final_norm"] = layers.norm_init(cfg, device=dev)
    else:
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
                cache=None, cache_pos=None, collect=False,
                mrope_positions=None):
    B, S, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = layers.dot(x, p["wq"]).to(x.dtype).reshape(B, S, hq, hd)
    k = layers.dot(x, p["wk"]).to(x.dtype).reshape(B, S, hkv, hd)
    v = layers.dot(x, p["wv"]).to(x.dtype).reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k = layers.rmsnorm(k, p["k_norm"], cfg.rms_eps)
    if not cfg.max_positions:                           # rotary models
        if cfg.mrope_sections and mrope_positions is not None:
            q = layers.apply_mrope(q, mrope_positions, cfg.rope_theta,
                                   cfg.mrope_sections)
            k = layers.apply_mrope(k, mrope_positions, cfg.rope_theta,
                                   cfg.mrope_sections)
        else:
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


def _cross_mixer(cfg, p, x, cache):
    """Decoder cross-attention over precomputed encoder K/V: the dense
    ``attention.reference``, as in JAX, not the flash kernel."""
    B, S, d = x.shape
    hq, hd = cfg.n_heads, cfg.hd
    q = layers.dot(x, p["wq"]).to(x.dtype).reshape(B, S, hq, hd)
    o = attn_mod.reference(q, cache["ck"], cache["cv"], causal=False)
    return layers.dot(o.reshape(B, S, hq * hd), p["wo"]).to(x.dtype)


def _cross_kv(cfg, p, enc_out):
    B, T, _ = enc_out.shape
    k = layers.dot(enc_out, p["wk"]).to(enc_out.dtype)
    v = layers.dot(enc_out, p["wv"]).to(enc_out.dtype)
    return {"ck": k.reshape(B, T, cfg.n_kv, cfg.hd),
            "cv": v.reshape(B, T, cfg.n_kv, cfg.hd)}


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
            cache_pos=ctx.get("cache_pos"), collect=ctx["collect"],
            mrope_positions=ctx.get("mrope_positions"))
        if c is not None:
            new_cache["attn"] = c
    elif mixer_kind == "rwkv":
        st = None if cache is None else cache["rwkv"]
        T = hn.shape[1]
        chunk = math.gcd(T, max(256, T // 128))   # as the JAX model picks it
        mo, st2 = rwkv_mod.time_mix(cfg, p["mixer"], hn, st, chunk=chunk)
        if keep:
            new_cache["rwkv"] = st2
    elif mixer_kind == "mamba":
        st = None if cache is None else cache["mamba"]
        T = hn.shape[1]
        chunk = math.gcd(T, min(512, max(64, T // 16)))   # as JAX picks it
        mo, st2 = mamba_mod.mamba_mixer(cfg, p["mixer"], hn, st, chunk=chunk)
        if keep:
            new_cache["mamba"] = st2
    else:
        raise ValueError(mixer_kind)
    h = h + mo

    if "cross" in p:
        hc = layers.apply_norm(cfg, p["norm_cross"], h)
        cross = cache["cross"] if cache is not None else ctx["cross_kv"]
        h = h + _cross_mixer(cfg, p["cross"], hc, cross)
        if keep:
            new_cache["cross"] = cross

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
    ``{"layers": [...]}`` or None.

    ``batch`` holds ``tokens`` (B, S) or ``embeds`` (B, S, d); with
    ``cfg.mrope_sections``, optionally ``mrope_positions`` (3, B, S); for
    the encoder-decoder, ``tokens`` and ``enc_embeds`` (B, T_enc, d): each
    decoder layer cross-attends to the encoded frames, and its cache also
    holds their K/V."""
    enc = (encode(cfg, params, batch["enc_embeds"], loops=loops)
           if cfg.is_encdec else None)
    h = _embed_in(cfg, params, batch)
    ctx = {"loops": loops, "collect": collect, "causal": True,
           "positions": torch.arange(h.shape[1], device=h.device)[None, :],
           "mrope_positions": batch.get("mrope_positions")}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    for p, kinds in zip(params["layers"], cfg.layer_kinds()):
        if enc is not None:
            ctx["cross_kv"] = _cross_kv(cfg, p["cross"], enc)
        h, a, c = _apply_layer(cfg, p, h, kinds, ctx)
        if a is not None:
            aux = aux + a
        caches.append(c)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return h, aux, ({"layers": caches} if collect else None)


def encode(cfg, params, enc_embeds, *, loops: str = "scan"):
    """The encoder: non-causal self-attention layers over the (B, T, d)
    frame embeddings (the stubbed audio front end's output; no positional
    embedding is added), then ``enc_final_norm``."""
    h = enc_embeds.to(cfg.adtype)
    ctx = {"loops": loops, "collect": False, "causal": False,
           "positions": torch.arange(h.shape[1], device=h.device)[None, :]}
    for p in params["enc_layers"]:
        h, _, _ = _apply_layer(cfg, p, h, ("attn", "dense"), ctx)
    return layers.apply_norm(cfg, params["enc_final_norm"], h)


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
    elif mixer_kind == "mamba":
        mc = cfg.mamba
        d_in = mc.expand * d
        c["mamba"] = {"h": torch.zeros((B, d_in, mc.d_state),
                                       dtype=torch.float32, device=dev),
                      "conv": torch.zeros((B, mc.d_conv - 1, d_in),
                                          dtype=dtype, device=dev)}
    if ffn_kind == "rwkv_cmix":
        c["cshift"] = torch.zeros((B, d), dtype=dtype, device=dev)
    return c


def init_cache(cfg, B, max_len, enc_len=0, *, device="cuda"):
    """Zero caches for ``B`` sequences of up to ``max_len`` positions; the
    encoder-decoder's also hold ``enc_len`` frames of cross K/V."""
    dev = resolve_device(device)
    caches = [_layer_cache_init(cfg, kinds, B, max_len, cfg.adtype, dev)
              for kinds in cfg.layer_kinds()]
    if cfg.is_encdec:
        shape = (B, enc_len, cfg.n_kv, cfg.hd)
        for c in caches:
            c["cross"] = {"ck": torch.zeros(shape, dtype=cfg.adtype,
                                            device=dev),
                          "cv": torch.zeros(shape, dtype=cfg.adtype,
                                            device=dev)}
    return {"layers": caches}


def prefill(cfg, params, batch, *, loops: str = "scan"):
    """Full-sequence forward that also returns the cache (kv/state)."""
    logits, _, caches = forward(cfg, params, batch, loops=loops, collect=True)
    return logits[:, -1:], caches


def decode_step(cfg, params, cache, token, pos):
    """One decode step.  token: (B,) integers; pos: int (the write slot).

    Returns (logits (B,1,V), new_cache).  Attention caches are written in
    place at ``pos`` (see ``_attn_mixer``); the encoder-decoder's cross K/V
    come from the cache, unchanged.  Rotary models rotate by the 1-D
    ``pos``, M-RoPE ones too: the reference passes no M-RoPE positions in
    decode.
    """
    pos = int(pos)
    h = params["embed"][token][:, None].to(cfg.adtype)       # (B,1,d)
    if cfg.max_positions:
        h = h + params["pos_embed"][pos][None, None].to(cfg.adtype)
    ctx = {"loops": "scan", "collect": False, "causal": True,
           "positions": torch.full((1, 1), pos, device=h.device),
           "cache_pos": pos, "mrope_positions": None}
    new_layers = []
    for p, kinds, c in zip(params["layers"], cfg.layer_kinds(),
                           cache["layers"]):
        h, _, nc = _apply_layer(cfg, p, h, kinds, ctx, cache=c)
        new_layers.append(nc)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return _unembed(cfg, params, h), {"layers": new_layers}
