"""Model configuration covering the 10 assigned architectures.

Counterpart of ``repro.models.config``.  ``adtype`` / ``pdtype`` return
``torch.dtype``s.  ``use_pallas`` is kept as a field so that configurations
read the same in both packages, and nothing reads it: the port's kernels
are chosen by the device of the tensors (a CUDA tensor launches the kernel,
a CPU tensor takes the plain version).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> ceil(d_model / 16)

    def rank(self, d_model: int) -> int:
        return self.dt_rank or max(1, -(-d_model // 16))


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0       # per-expert hidden width
    n_shared: int = 0          # always-active shared experts (DeepSeekMoE)
    first_k_dense: int = 0     # leading dense layers (kept out of the scan)
    every: int = 1             # MoE layer stride (Jamba: 2)
    capacity_factor: float = 1.25
    renorm_top_k: bool = True  # DeepSeek-style renormalized gates


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> d_model // n_heads
    # --- attention flavor ---
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim split
    # --- block pattern ---
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: bool = False
    rwkv_head_dim: int = 64
    attn_every: int = 1        # hybrid: 1 attention per this many layers
    attn_offset: int = 0       # position of the attn layer inside a block
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    max_positions: int = 0     # learned positional embedding table (0 = RoPE)
    # --- misc ---
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "swiglu"        # swiglu | gelu
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # --- numerics / execution ---
    dtype: str = "bfloat16"        # activations
    param_dtype: str = "bfloat16"
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    attn_triangle: bool = False    # unrolled lower-triangle blocking (skips
                                   # fully-masked kv blocks; exact FLOP savings)
    seq_parallel: bool = False     # Megatron-SP: residual stream sharded on S
                                   # over 'model' (norms distributed; TP
                                   # all-reduces become RS/AG pairs)
    remat: str = "full"            # none | dots | full
    loss_chunks: int = 8           # unembed+loss token chunking (memory)
    grad_accum: int = 1            # microbatches per train step (unrolled)
    scan_layers: bool = True
    fsdp: bool = False             # shard the d_model/d_ff param dim on 'data'
    kv_cache_seq_shard: bool = False  # sequence-sharded KV cache (CP decode)
    flash_decode: bool = True      # constrained distributed-flash decode over
                                   # S-sharded caches (False = naive baseline)
    use_pallas: bool = False       # read by nothing (see the module docstring)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def adtype(self):
        return getattr(torch, self.dtype)

    @property
    def pdtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def block_len(self) -> int:
        """Scan super-block length (LCM of the layer-pattern periods)."""
        import math
        period = self.attn_every
        if self.moe is not None:
            period = math.lcm(period, self.moe.every)
        return period

    def layer_kinds(self) -> list:
        """Static per-layer (mixer, ffn) kinds, after first_k_dense."""
        first = self.moe.first_k_dense if self.moe else 0
        kinds = []
        for i in range(self.n_layers):
            if self.rwkv:
                mixer = "rwkv"
            elif self.mamba is not None and self.attn_every > 1:
                mixer = ("attn" if i % self.attn_every == self.attn_offset
                         else "mamba")
            elif self.mamba is not None:
                mixer = "mamba"
            else:
                mixer = "attn"
            if self.rwkv:
                ffn = "rwkv_cmix"
            elif self.moe is not None and i >= first and \
                    i % self.moe.every == (self.moe.every - 1 if self.moe.every > 1 else 0):
                ffn = "moe"
            else:
                ffn = "dense"
            kinds.append((mixer, ffn))
        return kinds

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}
