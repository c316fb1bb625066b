"""The tenant-side language models (counterpart of ``repro.models``).

Every family is ported for serving: dense, MoE, RWKV6, Mamba and Jamba's
hybrid interleave, Qwen2-VL's M-RoPE and the Whisper encoder-decoder
(``encode``), and trains through ``loss_fn`` (the token-chunked cross
entropy; ``repro_torch.launch.steps`` builds the train step and
``repro_torch.optim`` holds AdamW).  Each model function takes a
``Distribution`` (``LOCAL`` by default): under a mesh the parameter specs
(``param_specs``, ``named_shardings``) and the model's constraints are
checked, and the GQA repeat, the sequence-sharded decode and the
expert-parallel MoE change values as in the reference;
``repro_torch.models.sharding`` lays out the port's mesh and says what has
no eager counterpart.
"""
from repro_torch.models.config import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                       PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
                                       MambaConfig, ModelConfig, MoEConfig,
                                       ShapeConfig)
from repro_torch.models.transformer import (decode_step, encode, forward,
                                            init_cache, init_params, loss_fn,
                                            prefill)
from repro_torch.models.sharding import (LOCAL, Distribution,
                                         named_shardings, param_specs)

__all__ = [
    "ALL_SHAPES", "DECODE_32K", "LOCAL", "LONG_500K", "PREFILL_32K",
    "SHAPES_BY_NAME", "TRAIN_4K", "Distribution", "MambaConfig",
    "ModelConfig", "MoEConfig", "ShapeConfig", "decode_step", "encode",
    "forward", "init_cache", "init_params", "loss_fn", "named_shardings",
    "param_specs", "prefill",
]
