"""RWKV-6 (Finch) 3B — attention-free RNN with data-dependent decay
[arXiv:2404.05892].

32L d_model=2560 (40 heads x 64) d_ff=8960 vocab=65536.

SWAN is inapplicable here: there is no KV cache to compress — the serving
state is a constant-size [H, d_k, d_v] matrix per layer.  The reference's
``tp_style="heads"`` is left out: the port has no sharding yet.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm",
        n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_head=64,
        d_ff=8960, vocab_size=65536,
        norm="layernorm", act="relu_sq",   # rwkv channel-mix uses squared relu
        pos="none",
        rwkv=RWKVConfig(head_dim=64),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256,
        norm="layernorm", act="relu_sq", pos="none",
        rwkv=RWKVConfig(head_dim=16),
    )
