"""Jamba-v0.1 52B [arXiv:2403.19887; hf]: 4 super-blocks of 8 layers
(attention at in-block offset 4, Mamba elsewhere), MoE (16e top-2) on every
second layer.  Hybrid: runs long_500k (O(1) Mamba state + 4 attn layers with
sequence-sharded KV)."""
from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig

ID = "jamba-v0.1-52b"


def get_config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="hybrid", n_layers=32, d_model=4096, n_heads=32,
        n_kv=8, d_ff=14336, vocab=65536, head_dim=128, rope_theta=1e4,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2,
                      capacity_factor=1.25),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        attn_every=8, attn_offset=4, fsdp=True, grad_accum=8
    )


def reduced_config() -> ModelConfig:
    return get_config().replace(
        n_layers=8, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
        head_dim=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256, every=2,
                      capacity_factor=4.0),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        dtype="float32", param_dtype="float32", attn_q_chunk=16,
        attn_kv_chunk=16, fsdp=False, grad_accum=1)
