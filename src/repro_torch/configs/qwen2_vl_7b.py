"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].  Vision frontend is a stub:
input_specs supply precomputed patch embeddings + M-RoPE position ids."""
from repro_torch.models.config import ModelConfig

ID = "qwen2-vl-7b"


def get_config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="vlm", n_layers=28, d_model=3584, n_heads=28, n_kv=4,
        d_ff=18944, vocab=152064, head_dim=128, rope_theta=1e6,
        mrope_sections=(16, 24, 24),       # temporal/height/width of hd/2=64
        fsdp=True, grad_accum=8,
    )


def reduced_config() -> ModelConfig:
    return get_config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
        head_dim=32, mrope_sections=(4, 6, 6), dtype="float32",
        param_dtype="float32", attn_q_chunk=16, attn_kv_chunk=16, fsdp=False, grad_accum=1)
