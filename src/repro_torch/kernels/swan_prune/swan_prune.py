"""Fused SWAN winnowing (rotate, magnitude top-k, pack): the CUDA kernel's
wrapper.

``swan_prune`` has the contract of the TPU kernel ``swan_prune_pallas``
(``repro/kernels/swan_prune/swan_prune.py:58``): x [B,Kv,S,dh] (post-RoPE k
or v, f32 or bf16) rotated by ``p_rot [Kv,dh,dh]`` in f32, the ``k_max``
largest |x̂| of each vector in descending order with ties to the lowest
index, packed as (vals [B,Kv,S,k_max] in x's dtype, idx int8).  ``tile``
is the caller's contract (``S % min(tile, S) == 0``, as the reference
asserts); the CUDA row tile is the kernel's own.  The reference's
``interpret`` flag has no counterpart: the device of ``x`` decides.

For CUDA tensors it launches ``csrc/swan_prune.cu`` (persistent blocks,
one an SM, each walking 64-vector tiles of one kv head; bf16 x rotates on
the tensor cores against ``P[kv]`` split once into three bf16 parts, f32 x
on CUDA cores; the top-k is a bitonic sorting network on one 64-bit key
per element; see the note at the top of that file) or raises; for CPU
tensors it runs the plain twin ``swan_prune_plain``.
Arguments are checked the same way on both devices.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.kernels.build import CudaKernel, CudaLibrary
from repro_torch.kernels.swan_prune.ref import swan_prune_reference

# the plain PyTorch version of the kernel's function
swan_prune_plain = swan_prune_reference

_TYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE_ROWS = 64                           # kRows in the CUDA source
MAX_DH = 128                             # kD: int8 indices address dh <= 128
P_PARTS = 3                              # kParts: bf16 parts of f32 P
SMEM_PER_BLOCK = 232448                  # bytes a block may use on sm_90


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.swan_prune_launch.argtypes = [i] + [p] * 4 + [i] * 5 + [p]
    lib.swan_prune_launch.restype = i
    lib.swan_prune_smem_bytes.argtypes = [i]
    lib.swan_prune_smem_bytes.restype = i
    lib.swan_prune_error_string.argtypes = [i]
    lib.swan_prune_error_string.restype = ctypes.c_char_p


def launch_cost(x, p_rot, k_max: int) -> Tuple[float, int]:
    """(flops, bytes) of one launch on x [B,Kv,S,dh]: the roofline model's
    (``analysis.roofline``), for the cost analyzer."""
    B, Kv, S, dh = x.shape
    nbytes = rl.swan_prune_kernel_bytes(B=B, Kv=Kv, S=S, dh=dh, k_max=k_max,
                                        x_bytes=x.element_size(),
                                        p_bytes=p_rot.element_size())
    return rl.swan_prune_kernel_flops(B=B, Kv=Kv, S=S, dh=dh), nbytes


LIBRARY = CudaLibrary("swan_prune",
                      Path(__file__).with_name("csrc") / "swan_prune.cu", _bind)
KERNEL = CudaKernel("swan_prune", LIBRARY, launch_cost)          # B6


def smem_bytes(x_bytes: int) -> int:
    """Shared memory of one block of the instance for x of ``x_bytes`` an
    element (2: bf16, 4: f32), at dh padded to ``MAX_DH``: ``P[kv]`` (three
    bf16 parts, or f32), two staged x tiles and two f32 x̂ tiles, rows
    padded by 16 bytes (the CUDA source's ``smem_bytes``)."""
    p = (P_PARTS * MAX_DH * (MAX_DH + 8) * 2 if x_bytes == 2
         else MAX_DH * MAX_DH * 4)
    x = 2 * TILE_ROWS * (MAX_DH + 16 // x_bytes) * x_bytes
    return p + x + 2 * TILE_ROWS * (MAX_DH + 8) * 4


def precheck(*, dh: int, k_max: int, x_bytes: int = 2) -> Dict[str, object]:
    """Static launch validation, budgeted against a Hopper block's shared
    memory.  Returns ``{"errors": [...], "smem_bytes": int}``."""
    errors: List[str] = []
    if not 1 <= k_max <= dh:
        errors.append(f"k_max={k_max} must lie in [1, dh={dh}]")
    if dh > MAX_DH:
        errors.append(f"dh={dh} > {MAX_DH}: int8 indices cannot address it")
    smem = smem_bytes(x_bytes)
    if smem > SMEM_PER_BLOCK:
        errors.append(f"shared memory {smem} B exceeds {SMEM_PER_BLOCK} B")
    return {"errors": errors, "smem_bytes": smem}


def _check(x, p_rot, k_max: int, tile: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} is not [B,Kv,S,dh]")
    B, Kv, S, dh = x.shape
    if tuple(p_rot.shape) != (Kv, dh, dh):
        raise ValueError(f"p_rot {tuple(p_rot.shape)}, expected {(Kv, dh, dh)}")
    t = min(tile, S)
    if t <= 0 or S % t:
        raise ValueError(f"S={S} not divisible by tile={t}")
    if x.dtype not in _TYPES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_TYPES)}")
    if p_rot.device != x.device:
        raise ValueError("x and p_rot must be on one device")
    errs = precheck(dh=dh, k_max=k_max, x_bytes=x.element_size())["errors"]
    if errs:
        raise ValueError("; ".join(errs))


def _launch(x, p_rot, k_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    p_rot = p_rot.float().contiguous()
    B, Kv, S, dh = x.shape
    vals = torch.empty((B, Kv, S, k_max), dtype=x.dtype, device=x.device)
    idx = torch.empty((B, Kv, S, k_max), dtype=torch.int8, device=x.device)
    lib = KERNEL.lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.swan_prune_launch(_TYPES[x.dtype], x.data_ptr(),
                                    p_rot.data_ptr(), vals.data_ptr(),
                                    idx.data_ptr(), B, Kv, S, dh, k_max,
                                    stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL.name} launch failed: "
                           + lib.swan_prune_error_string(err).decode())
    KERNEL.count_launch(x, p_rot, k_max)
    return vals, idx


def swan_prune(x: torch.Tensor, p_rot: torch.Tensor, k_max: int,
               tile: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate, top-k by magnitude and pack.  Launches the kernel for CUDA
    tensors, runs the plain twin for CPU tensors."""
    _check(x, p_rot, k_max, tile)
    if x.device.type == "cpu":
        return swan_prune_plain(x, p_rot, k_max)
    return _launch(x, p_rot, k_max)
