"""Meta-tensor input stand-ins for every (arch x shape) cell (counterpart
of ``repro.configs.specs``).

JAX lowers the dry run against ``ShapeDtypeStruct``s; the port runs each
cell's step eagerly on meta tensors of the same shapes and dtypes, which
hold no memory and launch nothing.  ``long_500k`` is live only for
sub-quadratic archs (SSM / hybrid), per the assignment; encoder-only archs
would skip decode but none are assigned (whisper is enc-dec, so its decode
cells run).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import init_cache
from repro_torch.models.config import ModelConfig, ShapeConfig

SUBQUADRATIC = ("rwkv6-7b", "jamba-v0.1-52b")


def cell_is_live(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, ("skipped: pure full-attention arch at 512k decode is "
                       "quadratic-cost (assignment: run only for SSM/hybrid)")
    return True, ""


def live_cells(archs: Dict[str, Any], shapes) -> list:
    out = []
    for aid, mod in archs.items():
        cfg = mod.get_config()
        for s in shapes:
            if cell_is_live(cfg, s)[0]:
                out.append((aid, s.name))
    return out


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Returns kwargs-specs for the step function of this cell, as meta
    tensors.

    train/prefill -> {"batch": {...}}
    decode        -> {"cache": ..., "token": ..., "pos": ...}
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    adt = cfg.adtype

    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        if cfg.family == "vlm":
            batch["embeds"] = _sds((B, S, cfg.d_model), adt)
            batch["mrope_positions"] = _sds((3, B, S), i32)
        elif cfg.is_encdec:
            batch["enc_embeds"] = _sds((B, S, cfg.d_model), adt)
            batch["tokens"] = _sds((B, S), i32)
        else:
            batch["tokens"] = _sds((B, S), i32)
        if shape.kind == "train":
            batch["targets"] = _sds((B, S), i32)
        return {"batch": batch}

    # decode: one new token against a cache of S positions
    cache = init_cache(cfg, B, S, enc_len=S if cfg.is_encdec else 0,
                       device="meta")
    return {"cache": cache, "token": _sds((B,), i32), "pos": _sds((), i32)}
