"""MiniCPM-2B [arXiv:2404.06395; hf]: llama-like, MHA (kv=36), tied
embeddings; trained with the WSD schedule (wired in repro.optim)."""
from repro_torch.models.config import ModelConfig

ID = "minicpm-2b"


def get_config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense", n_layers=40, d_model=2304, n_heads=36,
        n_kv=36, d_ff=5760, vocab=122753, head_dim=64, rope_theta=1e4,
        tie_embeddings=True, fsdp=False, grad_accum=8
    )


def reduced_config() -> ModelConfig:
    return get_config().replace(
        n_layers=2, d_model=128, n_heads=4, n_kv=4, d_ff=256, vocab=512,
        head_dim=32, dtype="float32", param_dtype="float32",
        attn_q_chunk=16, attn_kv_chunk=16, grad_accum=1)
