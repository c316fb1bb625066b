"""Qwen3-32B [hf:Qwen/Qwen3-8B family; hf]: qk_norm, GQA kv=8, head_dim 128."""
from repro_torch.models.config import ModelConfig

ID = "qwen3-32b"


def get_config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense", n_layers=64, d_model=5120, n_heads=64,
        n_kv=8, d_ff=25600, vocab=151936, head_dim=128, qk_norm=True,
        rope_theta=1e6, fsdp=True, grad_accum=16
    )


def reduced_config() -> ModelConfig:
    return get_config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
        head_dim=32, dtype="float32", param_dtype="float32",
        attn_q_chunk=16, attn_kv_chunk=16, fsdp=False, grad_accum=1)
