"""Architecture registry of the port and the config dataclasses.  The
port has the reference's dense family: llama3-8b (the paper's own
evaluation model), yi-9b (GQA with G = 8) and olmo-1b (MHA, non-parametric
LayerNorm, tied embeddings); llama3-405b waits for sharding, the other
families for their model code."""
from __future__ import annotations

from repro_torch.configs import llama3_8b, olmo_1b, yi_9b
from repro_torch.configs.base import (SHAPES, ModelConfig,  # noqa: F401
                                      OptimizerConfig, ShapeConfig,
                                      SwanConfig, TrainConfig)

_ARCHS = {"llama3-8b": llama3_8b, "olmo-1b": olmo_1b, "yi-9b": yi_9b}
ARCH_IDS = list(_ARCHS)


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has: {ARCH_IDS}")
    return _ARCHS[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
