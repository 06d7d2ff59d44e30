"""InternVL2-1B — VLM with a Qwen2-0.5B text backbone [arXiv:2404.16821].

24L d_model=896 14H (GQA kv=2: 7 queries per kv head) d_ff=4864
vocab=151655, q/k/v biases.  The InternViT frontend is a stub, as in the
reference: 256 precomputed patch embeddings are prepended to the tokens
(``launch.io.make_batch`` draws them).  14 heads / d_model 896 do not
divide a 16-way model axis: ``tp_style="fsdp_model"`` stores the
parameters sharded over it instead.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
        d_ff=4864, vocab_size=151655,
        norm="rmsnorm", act="silu", rope_theta=1000000.0,
        qkv_bias=True, n_prefix_tokens=256, tp_style="fsdp_model",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", family="vlm",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_head=8,
        d_ff=112, vocab_size=256,
        norm="rmsnorm", act="silu", qkv_bias=True, n_prefix_tokens=8,
        tp_style="fsdp_model",
    )
