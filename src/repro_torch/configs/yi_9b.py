"""Yi-9B — llama-architecture dense GQA decoder [arXiv:2403.04652].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
kv=4 gives the strongest GQA grouping (G=8) in the pool — exercises SWAN's
grouped joint-SVD path hardest.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_head=128,
        d_ff=11008, vocab_size=64000,
        norm="rmsnorm", act="silu", rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=1, d_head=8,
        d_ff=160, vocab_size=256,
        norm="rmsnorm", act="silu",
    )
