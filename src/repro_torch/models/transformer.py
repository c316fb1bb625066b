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
form; caches follow the same flat order.

Distribution enters, as in JAX, only through a ``Distribution`` argument
(``dist``, default ``LOCAL``; ``models/sharding.py`` lays out the port's
mesh).  Its constraints (``_shard_heads``, ``_seq_constrain``, the
residual, FFN and logits constraints) schedule XLA and change no value:
``Distribution.constrain`` checks their specs and returns the tensor.  Two
things here change values under a mesh, as they do in the reference: with
no cache and a tensor-parallel degree ``tp`` above the key/value heads
(``hq % tp == 0``, ``tp % hkv == 0``) keys and values are repeated ``tp //
hkv`` times before attention, so the flash kernel runs at ``Hkv = tp``
(the collected cache stays un-repeated); and a decode step whose kv heads
do not divide ``tp`` (or with ``cfg.kv_cache_seq_shard``) takes
``decode_attention``'s sequence-sharded form.  MoE layers run
``moe.moe_apply`` under ``dist``.

Training: ``loss_fn`` is JAX's token-chunked cross entropy, each chunk
recomputed in the backward (``torch.utils.checkpoint``).  ``cfg.remat``
wraps what JAX's ``_remat_wrap`` wraps: each block of ``cfg.block_len``
layers after the MoE head layers, and each encoder and decoder layer of
the encoder-decoder (``none``: no wrapper; ``full``: nothing saved inside;
``dots``: the matrix products' outputs saved, the rest recomputed).  It
changes memory, not values, and does nothing under ``torch.no_grad()``.
JAX's ``_grad_transparent_barrier`` between loss chunks only orders XLA's
schedule and has an identity gradient; eager PyTorch runs the chunks in
program order, so it has no counterpart.  On the card the prefill kernels
(``flash_attention``, and ``wkv6`` where ``T > chunk``) run under grad as
``torch.autograd.Function``s whose backward passes are CUDA kernels too
(``csrc/flash_attention_bwd.cu``, ``csrc/wkv6_bwd.cu``); remat reruns
their forward kernels.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import LOCAL, Distribution
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

    ``gen`` is an int seed or a ``torch.Generator`` on ``device``.  With
    ``device="meta"`` it is None: the tree's shapes and dtypes are built on
    meta tensors and nothing is drawn (JAX's ``eval_shape`` of
    ``init_params``, which the dry run costs against).
    """
    dev = resolve_device(device)
    if dev.type == "meta":
        if gen is not None:
            raise ValueError("meta parameters draw nothing: pass gen=None")
        gen = layers.NoDraws()
    elif isinstance(gen, int):
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

def _shard_heads(dist, x, n):
    """The reference's head-axis constraint: it schedules XLA and changes
    no value (``Distribution.constrain`` checks its spec)."""
    tp_size = dist.tp_size()
    if tp_size > 1 and n % tp_size == 0:
        return dist.constrain(x, dist.dp_axes, None, dist.tp, None)
    return x


def _attn_mixer(cfg, p, x, positions, dist, *, causal=True, loops="scan",
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
    q = _shard_heads(dist, q, hq)
    k = _shard_heads(dist, k, hkv)
    v = _shard_heads(dist, v, hkv)

    new_cache = None
    unrep_kv = {"k": k, "v": v}
    tp = dist.tp_size()
    if (cache is None and tp > 1 and hkv < tp and hq % tp == 0
            and tp % hkv == 0):
        # the reference's GQA repeat (GSPMD cannot shard the grouped
        # reshape below tp kv heads): the same function, the kernel at
        # Hkv = tp
        rep = tp // hkv
        k = _shard_heads(dist, k.repeat_interleave(rep, dim=2), tp)
        v = _shard_heads(dist, v.repeat_interleave(rep, dim=2), tp)
    if cache is not None:                               # decode (S == 1)
        # JAX donates the cache to dynamic_update_slice; here the slot is
        # written in place, so the caller's cache tensors change.
        cache["k"][:, cache_pos:cache_pos + S] = k
        cache["v"][:, cache_pos:cache_pos + S] = v
        seq_sharded = cfg.flash_decode and (
            cfg.kv_cache_seq_shard or (tp > 1 and hkv % tp != 0))
        o = attn_mod.decode_attention(q, cache["k"], cache["v"],
                                      kv_len=cache_pos + 1, dist=dist,
                                      seq_sharded=seq_sharded)
        new_cache = cache
    else:
        o = attn_mod.attention(
            q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk,
            kv_chunk=cfg.attn_kv_chunk, loops=loops,
            triangle=cfg.attn_triangle and causal)
        if collect:
            new_cache = unrep_kv                 # the cache stays un-repeated
    out = layers.dot(o.reshape(B, S, hq * hd), p["wo"]).to(x.dtype)
    return dist.constrain(out, dist.dp_axes, None, None), new_cache


def _cross_mixer(cfg, p, x, dist, cache):
    """Decoder cross-attention over precomputed encoder K/V: the dense
    ``attention.reference``, as in JAX, not the flash kernel."""
    B, S, d = x.shape
    hq, hd = cfg.n_heads, cfg.hd
    q = layers.dot(x, p["wq"]).to(x.dtype).reshape(B, S, hq, hd)
    o = attn_mod.reference(q, cache["ck"], cache["cv"], causal=False)
    out = layers.dot(o.reshape(B, S, hq * hd), p["wo"]).to(x.dtype)
    return dist.constrain(out, dist.dp_axes, None, None)


def _cross_kv(cfg, p, enc_out):
    B, T, _ = enc_out.shape
    k = layers.dot(enc_out, p["wk"]).to(enc_out.dtype)
    v = layers.dot(enc_out, p["wv"]).to(enc_out.dtype)
    return {"ck": k.reshape(B, T, cfg.n_kv, cfg.hd),
            "cv": v.reshape(B, T, cfg.n_kv, cfg.hd)}


def _seq_constrain(cfg, dist, h):
    """The reference's Megatron sequence parallelism (the residual stream
    sharded on S over the TP axis): it schedules XLA and changes no value
    (``Distribution.constrain`` checks its spec)."""
    if cfg.seq_parallel and dist.tp is not None and h.shape[1] > 1 \
            and h.shape[1] % dist.tp_size() == 0:
        return dist.constrain(h, dist.dp_axes, dist.tp, None)
    return h


def _apply_layer(cfg, p, h, kinds, ctx, cache=None):
    """Returns (h, aux, new_cache); aux is the MoE layer's load-balance
    loss, None for the other FFNs (JAX's f32 zero, which would cost a
    kernel launch a layer here)."""
    mixer_kind, ffn_kind = kinds
    dist = ctx["dist"]
    new_cache: Dict[str, Any] = {}
    keep = ctx["collect"] or cache is not None

    h = _seq_constrain(cfg, dist, h)
    hn = layers.apply_norm(cfg, p["norm1"], h)
    if mixer_kind == "attn":
        mo, c = _attn_mixer(
            cfg, p["mixer"], hn, ctx["positions"], dist, causal=ctx["causal"],
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
        h = h + _cross_mixer(cfg, p["cross"], hc, dist, cross)
        if keep:
            new_cache["cross"] = cross

    h = _seq_constrain(cfg, dist, h)
    hn = layers.apply_norm(cfg, p["norm2"], h)
    aux = None
    if ffn_kind == "dense":
        fo = layers.mlp_apply(cfg, p["ffn"], hn)
        fo = dist.constrain(fo, dist.dp_axes, None, None)
    elif ffn_kind == "moe":
        gates, idx, aux = moe_mod.route(cfg, p["ffn"], hn)
        fo = moe_mod.moe_apply(cfg, p["ffn"], hn, gates, idx, dist)
    elif ffn_kind == "rwkv_cmix":
        st = None if cache is None else cache["cshift"]
        fo, st2 = rwkv_mod.channel_mix(cfg, p["ffn"], hn, st)
        if keep:
            new_cache["cshift"] = st2
    else:
        raise ValueError(ffn_kind)
    return h + fo, aux, new_cache


# ==========================================================================
# activation rematerialisation
# ==========================================================================

# The matrix products that ``remat="dots"`` saves (JAX's ``checkpoint_dots``
# saves every dot): ``layers.dot`` / ``bmm`` on the card (the ``out_dtype``
# overloads) and the CPU's f32 products and einsums, matched by packet so
# that every overload counts.
_PRODUCTS = frozenset({torch.ops.aten.mm, torch.ops.aten.bmm,
                       torch.ops.aten.addmm, torch.ops.aten.baddbmm})


def _save_products(ctx, op, *args, **kwargs):
    if getattr(op, "overloadpacket", None) in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, context_fn=noop_context_fn):
    """``fn`` recomputed in the backward (``torch.utils.checkpoint``, non
    reentrant) when autograd records, called as it is otherwise."""
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return run


def _remat_wrap(cfg, fn):
    """JAX's ``_remat_wrap``: ``none`` keeps ``fn``; ``dots`` saves the
    matrix products' outputs and recomputes the rest; anything else
    (``full``) saves nothing inside ``fn``."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return _checkpointed(fn, functools.partial(
            create_selective_checkpoint_contexts, _save_products))
    return _checkpointed(fn)


# ==========================================================================
# forward / prefill / decode
# ==========================================================================

def _embed_in(cfg, params, batch, dist):
    if "embeds" in batch:
        h = batch["embeds"].to(cfg.adtype)
    else:
        h = params["embed"][batch["tokens"]].to(cfg.adtype)
    if cfg.max_positions:
        S = h.shape[1]
        h = h + params["pos_embed"][:S][None].to(cfg.adtype)
    return dist.constrain(h, dist.dp_axes, None, None)


def run_layers(cfg, layer_params, kinds, h, aux, ctx, enc=None):
    """Layers in order, as the backbone runs a block: each decoder layer's
    cross K/V from the encoded frames ``enc``, the MoE layers'
    load-balance losses added to ``aux``.  Returns (h, aux, caches)."""
    caches = []
    for p, kind in zip(layer_params, kinds):
        lctx = ctx if enc is None else {
            **ctx, "cross_kv": _cross_kv(cfg, p["cross"], enc)}
        h, a, c = _apply_layer(cfg, p, h, kind, lctx)
        if a is not None:
            aux = aux + a
        caches.append(c)
    return h, aux, caches


def backbone(cfg: ModelConfig, params, batch, dist: Distribution = LOCAL,
             *, loops: str = "scan", collect: bool = False):
    """Runs everything up to (and incl.) the final norm.
    Returns (h, aux, caches): aux sums the MoE layers' load-balance losses
    in layer order (f32 zero without MoE layers); caches is
    ``{"layers": [...]}`` or None.

    ``batch`` holds ``tokens`` (B, S) or ``embeds`` (B, S, d); with
    ``cfg.mrope_sections``, optionally ``mrope_positions`` (3, B, S); for
    the encoder-decoder, ``tokens`` and ``enc_embeds`` (B, T_enc, d): each
    decoder layer cross-attends to the encoded frames, and its cache also
    holds their K/V.  Under grad each block runs through ``_remat_wrap``."""
    enc = (encode(cfg, params, batch["enc_embeds"], dist, loops=loops)
           if cfg.is_encdec else None)
    h = _embed_in(cfg, params, batch, dist)
    ctx = {"dist": dist, "loops": loops, "collect": collect, "causal": True,
           "positions": torch.arange(h.shape[1], device=h.device)[None, :],
           "mrope_positions": batch.get("mrope_positions")}
    kinds = cfg.layer_kinds()

    def run(h, aux, lo, hi):
        return run_layers(cfg, params["layers"][lo:hi], kinds[lo:hi], h, aux,
                          ctx, enc)

    # the MoE head layers run alone and unwrapped, as JAX keeps them out
    # of its scan; then JAX's scan bodies of cfg.block_len layers (one a
    # body for the encoder-decoder's decoder), each through _remat_wrap; a
    # depth cut inside a block (Jamba served at 5 layers) ends with a
    # shorter one, where JAX would refuse the depth
    first = cfg.moe.first_k_dense if cfg.moe else 0
    bl = 1 if cfg.is_encdec else cfg.block_len
    n = cfg.n_layers
    block = _remat_wrap(cfg, run)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    for lo, hi, fn in ([(i, i + 1, run) for i in range(first)]
                       + [(lo, min(lo + bl, n), block)
                          for lo in range(first, n, bl)]):
        h, aux, c = fn(h, aux, lo, hi)
        caches += c
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return h, aux, ({"layers": caches} if collect else None)


def encode(cfg, params, enc_embeds, dist: Distribution = LOCAL, *,
           loops: str = "scan"):
    """The encoder: non-causal self-attention layers over the (B, T, d)
    frame embeddings (the stubbed audio front end's output; no positional
    embedding is added), then ``enc_final_norm``.  Under grad each layer
    runs through ``_remat_wrap``."""
    h = dist.constrain(enc_embeds.to(cfg.adtype), dist.dp_axes, None, None)
    ctx = {"dist": dist, "loops": loops, "collect": False, "causal": False,
           "positions": torch.arange(h.shape[1], device=h.device)[None, :]}

    def run(h, p):
        return _apply_layer(cfg, p, h, ("attn", "dense"), ctx)[0]

    layer = _remat_wrap(cfg, run)
    for p in params["enc_layers"]:
        h = layer(h, p)
    return layers.apply_norm(cfg, params["enc_final_norm"], h)


def _unembed(cfg, params, h, dist):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed_w"]
    logits = layers.dot(h, w)
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return dist.constrain(logits, dist.dp_axes, None, dist.tp)


def forward(cfg: ModelConfig, params, batch, dist: Distribution = LOCAL, *,
            loops: str = "scan", collect: bool = False):
    """Teacher-forcing forward.  Returns (logits f32, aux, caches)."""
    h, aux, caches = backbone(cfg, params, batch, dist, loops=loops,
                              collect=collect)
    return _unembed(cfg, params, h, dist), aux, caches


# ==========================================================================
# loss
# ==========================================================================

def _nll_chunk(cfg, params, h_chunk, tgt_chunk, dist):
    """Per-token negative log-likelihood (B, S_c) of one chunk, in f32."""
    logits = _unembed(cfg, params, h_chunk, dist).to(torch.float32)
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
    # JAX picks the target logit by an iota mask and a sum (a
    # vocab-sharding-friendly gather); a gather picks the same value
    tgt = torch.gather(logits, -1, tgt_chunk[..., None].long())[..., 0]
    return lse - tgt


def loss_fn(cfg, params, batch, dist: Distribution = LOCAL, *,
            loops: str = "scan", aux_coef: float = 0.01):
    """Token-chunked cross entropy: the (tokens, vocab) logits matrix is
    never formed in full.  ``gcd(S, cfg.loss_chunks)`` chunks run in a
    Python loop, each recomputed in the backward, so no f32 logits block is
    kept for it.  ``batch["targets"]`` (B, S) are the next tokens; an
    optional ``batch["loss_mask"]`` (B, S) weights them (bool or float; the
    mean is over its sum, at least 1).  Returns ``(loss + aux_coef * aux,
    {"nll": loss, "aux": aux})``, ``aux`` being the MoE load-balance
    loss."""
    h, aux, _ = backbone(cfg, params, batch, dist, loops=loops)
    B, S, d = h.shape
    tg = batch["targets"]
    mask = batch.get("loss_mask")
    n_chunks = math.gcd(S, max(1, cfg.loss_chunks))
    csz = S // n_chunks
    chunk_fn = _checkpointed(
        lambda hc, tc: _nll_chunk(cfg, params, hc, tc, dist))
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    den = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * csz, (i + 1) * csz)
        nll = chunk_fn(h[:, sl], tg[:, sl])
        if mask is not None:
            mc = mask[:, sl]
            nll_sum = nll_sum + torch.sum(nll * mc)
            den = den + torch.sum(mc)
        else:
            nll_sum = nll_sum + torch.sum(nll)
            den = den + nll.numel()
    loss = nll_sum / torch.clamp(den, min=1.0)
    return loss + aux_coef * aux, {"nll": loss, "aux": aux}


# ==========================================================================
# caches: init / prefill / decode
# ==========================================================================

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


def prefill(cfg, params, batch, dist: Distribution = LOCAL, *,
            loops: str = "scan"):
    """Full-sequence forward that also returns the cache (kv/state)."""
    logits, _, caches = forward(cfg, params, batch, dist, loops=loops,
                                collect=True)
    return logits[:, -1:], caches


def decode_step(cfg, params, cache, token, pos,
                dist: Distribution = LOCAL):
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
    h = dist.constrain(h, dist.dp_axes, None, None)
    ctx = {"dist": dist, "loops": "scan", "collect": False, "causal": True,
           "positions": torch.full((1, 1), pos, device=h.device),
           "cache_pos": pos, "mrope_positions": None}
    new_layers = []
    for p, kinds, c in zip(params["layers"], cfg.layer_kinds(),
                           cache["layers"]):
        h, _, nc = _apply_layer(cfg, p, h, kinds, ctx, cache=c)
        new_layers.append(nc)
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return _unembed(cfg, params, h, dist), {"layers": new_layers}
