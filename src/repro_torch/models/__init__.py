"""The tenant-side language models (counterpart of ``repro.models``).

Every family is ported for serving: dense, MoE, RWKV6, Mamba and Jamba's
hybrid interleave, Qwen2-VL's M-RoPE and the Whisper encoder-decoder
(``encode``), and trains through ``loss_fn`` (the token-chunked cross
entropy; ``repro_torch.launch.steps`` builds the train step and
``repro_torch.optim`` holds AdamW).  The sharding rules (``LOCAL``,
``Distribution``, ``named_shardings``, ``param_specs``) are not ported
(ROADMAP Queue 1 item 20).
"""
from repro_torch.models.config import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                       PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
                                       MambaConfig, ModelConfig, MoEConfig,
                                       ShapeConfig)
from repro_torch.models.transformer import (decode_step, encode, forward,
                                            init_cache, init_params, loss_fn,
                                            prefill)

__all__ = [
    "ALL_SHAPES", "DECODE_32K", "LONG_500K", "PREFILL_32K", "SHAPES_BY_NAME",
    "TRAIN_4K", "MambaConfig", "ModelConfig", "MoEConfig", "ShapeConfig",
    "decode_step", "encode", "forward", "init_cache", "init_params",
    "loss_fn", "prefill",
]
