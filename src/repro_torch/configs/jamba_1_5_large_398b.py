"""Jamba-1.5-Large (398B) — hybrid Mamba+attention MoE [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2,
Mamba:attention 1:7 interleave (one attention layer per 8), MoE every
second layer (Jamba's e=2 period).  SWAN applies to the 9 attention layers
(the only sequence-proportional state).  The full config shards its
parameters over 'data' too and its activations' sequence over 'model',
and keeps its AdamW moments in bfloat16.
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=24576, vocab_size=65536,
        norm="rmsnorm", act="silu", pos="none",   # jamba uses no positional encoding
        moe=MoEConfig(n_routed=16, n_shared=0, top_k=2, d_expert=24576,
                      moe_every=2, moe_offset=1),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        attn_period=8, attn_offset=4,
        fsdp_data=True, seq_shard=True,
        opt_state_dtype="bfloat16", grad_accum=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256,
        norm="rmsnorm", act="silu", pos="none",
        moe=MoEConfig(n_routed=4, n_shared=0, top_k=2, d_expert=128,
                      moe_every=2, moe_offset=1),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        attn_period=8, attn_offset=4,
    )
