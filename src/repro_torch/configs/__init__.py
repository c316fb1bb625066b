"""Registry of the 10 assigned architectures (``repro.configs``'s
counterpart).

The architecture specs are plain ``ModelConfig`` literals, copied from the
JAX package.  Every one of them can be built and served
(``repro_torch.models``); ``specs`` gives each cell's dry-run inputs as
meta tensors.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_moe_16b, jamba_v0_1_52b,
                                 kimi_k2_1t_a32b, minicpm_2b, qwen2_vl_7b,
                                 qwen3_0_6b, qwen3_32b, qwen3_8b, rwkv6_7b,
                                 whisper_base)
from repro_torch.models.config import ALL_SHAPES, SHAPES_BY_NAME, ShapeConfig

_MODULES = (qwen2_vl_7b, deepseek_moe_16b, kimi_k2_1t_a32b, qwen3_32b,
            qwen3_8b, minicpm_2b, qwen3_0_6b, rwkv6_7b, jamba_v0_1_52b,
            whisper_base)

ARCHS = {m.ID: m for m in _MODULES}
ARCH_IDS = tuple(ARCHS)


def get_config(arch_id: str):
    return ARCHS[arch_id].get_config()


def reduced_config(arch_id: str):
    return ARCHS[arch_id].reduced_config()


__all__ = ["ALL_SHAPES", "ARCHS", "ARCH_IDS", "SHAPES_BY_NAME", "ShapeConfig",
           "get_config", "reduced_config"]
