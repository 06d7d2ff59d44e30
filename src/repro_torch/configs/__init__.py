"""Architecture registry of the port (the dense family only) and the
config dataclasses."""
from __future__ import annotations

from repro_torch.configs import llama3_8b
from repro_torch.configs.base import (ModelConfig, OptimizerConfig,  # noqa: F401
                                      SwanConfig, TrainConfig)

_ARCHS = {"llama3-8b": llama3_8b}
ARCH_IDS = list(_ARCHS)


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has: {ARCH_IDS}")
    return _ARCHS[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
