"""The tenant-side language models (counterpart of ``repro.models``).

The dense, MoE and RWKV6 families are ported; ``encode`` (enc-dec) and
the sharding rules (``LOCAL``, ``Distribution``, ``named_shardings``,
``param_specs``) are not.  ``loss_fn`` raises until the training path is
ported.
"""
from repro_torch.models.config import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                       PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
                                       MambaConfig, ModelConfig, MoEConfig,
                                       ShapeConfig)
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            init_params, loss_fn, prefill)

__all__ = [
    "ALL_SHAPES", "DECODE_32K", "LONG_500K", "PREFILL_32K", "SHAPES_BY_NAME",
    "TRAIN_4K", "MambaConfig", "ModelConfig", "MoEConfig", "ShapeConfig",
    "decode_step", "forward", "init_cache", "init_params", "loss_fn",
    "prefill",
]
