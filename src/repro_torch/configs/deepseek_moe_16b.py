"""DeepSeekMoE-16B [arXiv:2401.06066; hf]: fine-grained 64 routed experts
(top-6, width 1408) + 2 shared experts; first layer dense (width 10944)."""
from repro_torch.models.config import ModelConfig, MoEConfig

ID = "deepseek-moe-16b"


def get_config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe", n_layers=28, d_model=2048, n_heads=16,
        n_kv=16, d_ff=10944, vocab=102400, head_dim=128, rope_theta=1e4,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                      first_k_dense=1, capacity_factor=1.25),
        fsdp=True, grad_accum=8,
    )


def reduced_config() -> ModelConfig:
    return get_config().replace(
        n_layers=3, d_model=128, n_heads=4, n_kv=4, d_ff=384, vocab=512,
        head_dim=32,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=2,
                      first_k_dense=1, capacity_factor=4.0),
        dtype="float32", param_dtype="float32", attn_q_chunk=16,
        attn_kv_chunk=16, fsdp=False, grad_accum=1)
