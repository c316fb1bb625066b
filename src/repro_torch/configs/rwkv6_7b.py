"""RWKV6-7B "Finch" [arXiv:2404.05892; hf]: attention-free, data-dependent
decay linear attention; O(1)-state decode (runs long_500k)."""
from repro_torch.models.config import ModelConfig

ID = "rwkv6-7b"


def get_config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="ssm", n_layers=32, d_model=4096, n_heads=64,
        n_kv=64, d_ff=14336, vocab=65536, rwkv=True, rwkv_head_dim=64,
        fsdp=True, grad_accum=8,
    )


def reduced_config() -> ModelConfig:
    return get_config().replace(
        n_layers=2, d_model=128, n_heads=8, n_kv=8, d_ff=256, vocab=512,
        rwkv_head_dim=16, dtype="float32", param_dtype="float32", fsdp=False, grad_accum=1)
