"""OLMo-1B — dense decoder with non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304, embeddings tied
to the output head.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=8192, vocab_size=50304,
        norm="nonparam_ln", act="silu", rope_theta=10000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256,
        norm="nonparam_ln", act="silu", tie_embeddings=True,
    )
