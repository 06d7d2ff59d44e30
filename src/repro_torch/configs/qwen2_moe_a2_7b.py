"""Qwen1.5/2-MoE-A2.7B — MoE decoder [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (MHA kv=16) d_ff=1408 vocab=151936,
MoE: 4 shared + 60 routed experts, top-4.  Qwen uses QKV biases.
``shard_experts=False``: 60 experts do not divide a 16-way model axis.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab_size=151936,
        norm="rmsnorm", act="silu", rope_theta=1000000.0,
        qkv_bias=True,
        moe=MoEConfig(n_routed=60, n_shared=4, top_k=4, d_expert=1408,
                      shard_experts=False),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=96, vocab_size=256,
        norm="rmsnorm", act="silu", qkv_bias=True,
        moe=MoEConfig(n_routed=6, n_shared=2, top_k=2, d_expert=96,
                      shard_experts=False),
    )
