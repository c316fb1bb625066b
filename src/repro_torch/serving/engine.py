"""Batched serving: prefill + greedy/sampled decode with managed caches.

Counterpart of ``repro.serving.engine``.  The attention KV cache is
allocated once, at the prompt length plus ``max_new_tokens``, and every
decode step writes its slot in place (JAX donates the cache to
``dynamic_update_slice`` instead).  The encoder-decoder's cross K/V are
computed once, at prefill, and read by every decode step.  Under a
``Distribution`` (``dist``) the prefill and every decode step run with it;
the padded cache is a fresh tensor, so the in-place writes never reach the
prefill's.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.models import LOCAL, Distribution, decode_step, prefill


def pad_attn_cache(cache, extra: int):
    """Grow every self-attention KV cache by ``extra`` zero positions
    (axis -3).  Returns a new cache; the other entries (recurrent states,
    the encoder-decoder's cross K/V) are shared, not grown."""
    def grow(x):
        out = x.new_zeros((*x.shape[:-3], x.shape[-3] + extra,
                           *x.shape[-2:]))
        out[..., :x.shape[-3], :, :] = x
        return out

    return {"layers": [
        {**c, "attn": {"k": grow(c["attn"]["k"]), "v": grow(c["attn"]["v"])}}
        if "attn" in c else c for c in cache["layers"]]}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def generate(cfg, params, prompt_tokens, *, max_new_tokens: int,
             dist: Distribution = LOCAL, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             return_logits: bool = False, stats: Optional[dict] = None,
             enc_embeds=None):
    """Greedy (or sampled) generation.  prompt_tokens: (B, S_prompt) int;
    for the encoder-decoder, ``enc_embeds`` (B, T_enc, d) are the encoder's
    input frames.

    Returns the (B, max_new_tokens) int64 tokens; with ``return_logits``
    also the (B, max_new_tokens, V) f32 logits each token was drawn from.
    Sampling (``temperature > 0``) draws from ``generator`` (a
    ``torch.Generator`` on the tokens' device), equal to JAX in
    distribution only.  Given a dict, ``stats`` receives ``prefill_s`` and
    ``decode_s``, host seconds each ending in a device synchronize.
    """
    B, S0 = prompt_tokens.shape
    dev = prompt_tokens.device
    t0 = time.perf_counter()
    batch = {"tokens": prompt_tokens}
    if enc_embeds is not None:
        batch["enc_embeds"] = enc_embeds
    logits, cache = prefill(cfg, params, batch, dist)
    cache = pad_attn_cache(cache, max_new_tokens)
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()

    def sample(lg):
        lg = lg[:, -1].to(torch.float32)
        if temperature <= 0.0:
            return torch.argmax(lg, dim=-1), lg
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0], lg

    tok, lg = sample(logits)
    toks, lgs = [tok], [lg]
    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(cfg, params, cache, tok, S0 + i, dist)
        tok, lg = sample(logits)
        toks.append(tok)
        lgs.append(lg)
    out = torch.stack(toks, dim=1)
    if stats is not None:
        _sync(dev)
        stats["prefill_s"] = t1 - t0
        stats["decode_s"] = time.perf_counter() - t1
    if return_logits:
        return out, torch.stack(lgs, dim=1)
    return out
