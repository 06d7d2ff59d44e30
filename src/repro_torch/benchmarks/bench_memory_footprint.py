"""Whole-model KV-cache memory accounting across the port's architectures
(port of ``benchmarks/bench_memory_footprint.py``; the paper's abstract
claim: 50-60% per-token savings at strong quality).

Emits dense vs SWAN cache bytes at the ``decode_32k`` serving shape (batch
128, 32768 tokens), per arch of the port's registry (deepseek-moe-16b,
qwen2-moe-a2.7b, llama3-8b, olmo-1b, yi-9b, internvl2-1b, whisper-small),
for the paper-faithful
setting (k = d_h/2, b = 128, fp16) and the 8-bit variant.  Pure arithmetic (paper Eq. 1).

    python -m repro_torch.benchmarks.bench_memory_footprint
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks.common import bench_record, emit
from repro_torch.configs import ARCH_IDS, SHAPES, SwanConfig, get_config
from repro_torch.core.analytical import model_cache_footprint
from repro_torch.models.registry import swan_applicable


def _run() -> None:
    shape = SHAPES["decode_32k"]
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not swan_applicable(cfg):
            emit("cache_footprint", 0.0, f"{arch}_swan=inapplicable_O(1)_state")
            continue
        for tag, swan in [
            ("fp16_k50", SwanConfig(k_max=cfg.d_head // 2, buffer=128)),
            ("int8_k50", SwanConfig(k_max=cfg.d_head // 2, buffer=128,
                                    quantize=True)),
        ]:
            fp = model_cache_footprint(cfg, swan, shape.global_batch,
                                       shape.seq_len)
            emit("cache_footprint", 0.0,
                 f"{arch}_{tag}_dense={fp.dense_bytes / 1e9:.1f}GB"
                 f"_swan={fp.swan_bytes / 1e9:.1f}GB_saving={fp.saving:.1%}")


def run():
    """Emit the rows; returns the recorder (rows and gates)."""
    with bench_record("memory_footprint_torch", torch.device("cpu")) as rec:
        _run()
    return rec


if __name__ == "__main__":
    run()
