"""Hand-written CUDA kernels of the port (one per TPU kernel ported).

``KERNELS`` lists every kernel, so a launcher or ``chip_smoke.py`` can
build their libraries all at once and read or reset their launch counts.
"""
from repro_torch.kernels.flash_prefill.flash_prefill import \
    KERNEL as FLASH_ATTENTION
from repro_torch.kernels.swan_chunk.swan_chunk import KERNEL as SWAN_CHUNK_STATS
from repro_torch.kernels.swan_chunk.swan_chunk import \
    KERNEL_PAGED as SWAN_CHUNK_STATS_PAGED
from repro_torch.kernels.swan_decode.swan_decode import KERNEL as SWAN_DECODE
from repro_torch.kernels.swan_decode.swan_decode import \
    KERNEL_PAGED as SWAN_DECODE_PAGED
from repro_torch.kernels.swan_prune.swan_prune import KERNEL as SWAN_PRUNE

KERNELS = [SWAN_DECODE, SWAN_DECODE_PAGED, SWAN_CHUNK_STATS,
           SWAN_CHUNK_STATS_PAGED, FLASH_ATTENTION, SWAN_PRUNE]
