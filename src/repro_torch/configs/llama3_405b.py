"""Llama-3-405B — dense GQA decoder [arXiv:2407.21783].

126L d_model=16384 128H (GQA kv=8: 16 queries per kv head) d_ff=53248
vocab=128256, RoPE theta 5e5.  The reference fits it on a 256-chip pod
with FSDP over 'data', TP over 'model', sequence sharding, gradient
accumulation and bfloat16 optimizer state; the smoke config keeps the
sharding and optimizer fields at 3 layers and G = 4.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
        d_ff=53248, vocab_size=128256,
        norm="rmsnorm", act="silu", rope_theta=500000.0,
        tp_style="heads", fsdp_data=True, seq_shard=True,
        opt_state_dtype="bfloat16", grad_accum=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
        d_ff=192, vocab_size=256,
        norm="rmsnorm", act="silu", rope_theta=500000.0,
        fsdp_data=True, seq_shard=True, opt_state_dtype="bfloat16",
    )
