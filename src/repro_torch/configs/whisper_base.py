"""Whisper-base [arXiv:2212.04356; unverified]: enc-dec; the conv/audio
frontend is a STUB per the assignment — input_specs provide precomputed frame
embeddings.  Learned positional embeddings sized for the 32k decode cell
(architecturally unrealistic for real whisper-base, exercised as assigned)."""
from repro_torch.models.config import ModelConfig

ID = "whisper-base"


def get_config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="encdec", n_layers=6, d_model=512, n_heads=8,
        n_kv=8, d_ff=2048, vocab=51865, head_dim=64, encoder_layers=6,
        max_positions=32768, norm="layernorm", act="gelu", fsdp=False, grad_accum=4
    )


def reduced_config() -> ModelConfig:
    return get_config().replace(
        n_layers=2, encoder_layers=2, d_model=128, n_heads=4, n_kv=4,
        d_ff=256, vocab=512, head_dim=32, max_positions=128,
        dtype="float32", param_dtype="float32", attn_q_chunk=16,
        attn_kv_chunk=16, grad_accum=1)
