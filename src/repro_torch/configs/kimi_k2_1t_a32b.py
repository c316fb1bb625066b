"""Kimi-K2 1T-A32B [arXiv:2501.kimi2; unverified, paper-table]: 384 routed
experts top-8 (width 2048) + 1 shared, first layer dense.  Assigned as GQA
kv=8 (the real model's MLA is out of assigned scope — DESIGN.md Sec. 6);
head_dim=128 for MXU alignment."""
from repro_torch.models.config import ModelConfig, MoEConfig

ID = "kimi-k2-1t-a32b"


def get_config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe", n_layers=61, d_model=7168, n_heads=64, n_kv=8,
        d_ff=18432, vocab=163840, head_dim=128, rope_theta=5e4,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1,
                      first_k_dense=1, capacity_factor=1.25),
        fsdp=True, grad_accum=16,
    )


def reduced_config() -> ModelConfig:
    return get_config().replace(
        n_layers=3, d_model=128, n_heads=4, n_kv=2, d_ff=384, vocab=512,
        head_dim=32,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=64, n_shared=1,
                      first_k_dense=1, capacity_factor=4.0),
        dtype="float32", param_dtype="float32", attn_q_chunk=16,
        attn_kv_chunk=16, fsdp=False, grad_accum=1)
