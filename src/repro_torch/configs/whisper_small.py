"""Whisper-small — encoder-decoder audio transformer [arXiv:2212.04356].

12L encoder + 12L decoder, d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865, learned positions, pre-LayerNorm, GELU MLP, every bias.  The
conv audio frontend is a stub, as in the reference: 1500 precomputed frame
embeddings (``launch.io.make_batch`` draws them).  SWAN applies to the
decoder's self-attention cache; ``SwanConfig.compress_cross_attn`` also
winnows the static cross-attention cache once at prefill.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_head=64,
        d_ff=3072, vocab_size=51865,
        norm="layernorm", act="gelu", pos="learned",
        qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        is_encoder_decoder=True, n_encoder_layers=12, encoder_seq=1500,
        tp_style="fsdp_model",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256,
        norm="layernorm", act="gelu", pos="learned",
        qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        is_encoder_decoder=True, n_encoder_layers=2, encoder_seq=32,
        tp_style="fsdp_model",
    )
