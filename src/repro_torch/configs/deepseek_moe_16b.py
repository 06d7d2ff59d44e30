"""DeepSeekMoE-16B — fine-grained MoE decoder [arXiv:2401.06066].

28L d_model=2048 16H (MHA kv=16) d_ff=1408 vocab=102400,
MoE: 2 shared + 64 routed experts, top-6.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab_size=102400,
        norm="rmsnorm", act="silu", rope_theta=10000.0,
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=96, vocab_size=256,
        norm="rmsnorm", act="silu",
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_expert=96),
    )
