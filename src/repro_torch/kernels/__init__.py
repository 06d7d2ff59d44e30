"""Hand-written CUDA kernels of the port (one per TPU kernel ported).

``KERNELS`` lists every kernel library, so a launcher or ``chip_smoke.py``
can build them all at once and read or reset their launch counts.
"""
from repro_torch.kernels.swan_decode.swan_decode import KERNEL as SWAN_DECODE

KERNELS = [SWAN_DECODE]
