"""Architecture registry of the port and the config dataclasses: every
arch of the reference's registry, in its order.  The port has the
reference's dense family: llama3-8b (the paper's own evaluation model),
llama3-405b (G = 16), yi-9b (GQA with G = 8) and olmo-1b (MHA,
non-parametric LayerNorm, tied embeddings); its ``moe`` family: deepseek-moe-16b
(64 routed experts, top-6, 2 shared) and qwen2-moe-a2.7b (60 routed,
top-4, 4 shared, q/k/v biases); its ``vlm`` family: internvl2-1b (G = 7,
256 patch embeddings ahead of the tokens); its ``encdec`` family:
whisper-small (an encoder over 1500 frames, cross-attention, learned
positions); its ``hybrid`` family: jamba-1.5-large-398b (Mamba mixers,
one attention layer in 8, MoE on every second layer, no positional
encoding); and its ``ssm`` family: rwkv6-3b (RWKV-6 time and channel
mixes, no attention, so no SWAN)."""
from __future__ import annotations

from repro_torch.configs import (deepseek_moe_16b, internvl2_1b,
                                 jamba_1_5_large_398b, llama3_8b,
                                 llama3_405b, olmo_1b, qwen2_moe_a2_7b,
                                 rwkv6_3b, whisper_small, yi_9b)
from repro_torch.configs.base import (SHAPES, MambaConfig,  # noqa: F401
                                      ModelConfig, MoEConfig,
                                      OptimizerConfig, RWKVConfig,
                                      ShapeConfig, SwanConfig, TrainConfig,
                                      shape_applicable)

# the reference registry's order
_ARCHS = {"deepseek-moe-16b": deepseek_moe_16b,
          "qwen2-moe-a2.7b": qwen2_moe_a2_7b, "llama3-8b": llama3_8b,
          "olmo-1b": olmo_1b, "llama3-405b": llama3_405b, "yi-9b": yi_9b,
          "internvl2-1b": internvl2_1b,
          "jamba-1.5-large-398b": jamba_1_5_large_398b,
          "whisper-small": whisper_small, "rwkv6-3b": rwkv6_3b}
ARCH_IDS = list(_ARCHS)


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has: {ARCH_IDS}")
    return _ARCHS[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
