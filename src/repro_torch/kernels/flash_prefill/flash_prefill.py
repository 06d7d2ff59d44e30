"""Causal (or full) GQA flash attention: the CUDA kernel's wrapper.

``flash_attention`` has the contract of the TPU kernel
``flash_attention_pallas`` (``repro/kernels/flash_prefill/flash_prefill.py:113``):
q [B,Sq,H,dh], k/v [B,Sk,Kv,dh] (f32 or bf16) -> o [B,Sq,H,dh] in q's
dtype, f32 scores and accumulators, the causal mask top-left (key ``t``
visible to query ``i`` iff ``t <= i``), ``l`` clamped at 1e-30.
``block_q``/``block_k`` are the caller's contract, checked as the
reference checks them (``Sq % min(block_q, Sq) == 0``, the same for k);
the CUDA tile is the kernel's own.

For CUDA tensors it launches ``csrc/flash_prefill.cu`` or raises; for CPU
tensors it runs the plain twin ``flash_attention_plain``.  The source has
one instance per dtype, both with all G heads of a kv group sharing each
K/V tile (see the note at the top of that file): bf16 on the tensor cores
by wgmma (two warpgroups per 128 query rows, K/V tiles of 64 keys in a
two-stage cp.async ring), f32 on CUDA cores (one block per 64 query rows,
K/V tiles of 32 keys).  Arguments are checked the same way on both
devices.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.kernels.build import CudaKernel, CudaLibrary
from repro_torch.kernels.flash_prefill.ref import flash_attention_plain

_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# (query rows per block, keys per tile) of each instance: tc::kBM, tc::kBN
# and f32::kQR, f32::kKT in the CUDA source
TILES = {torch.bfloat16: (128, 64), torch.float32: (64, 32)}
KV_STAGES = 2                            # tc::kStages: the bf16 K/V ring
SMEM_PER_BLOCK = 232448                  # bytes a block may use on sm_90
MAX_DH = 128                             # accumulator columns a row holds


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_prefill_launch.argtypes = [i] + [p] * 4 + [i] * 7 + [p]
    lib.flash_prefill_launch.restype = i
    lib.flash_prefill_error_string.argtypes = [i]
    lib.flash_prefill_error_string.restype = ctypes.c_char_p


def launch_cost(q, k, causal: bool) -> Tuple[float, int]:
    """(flops, bytes) of one launch on q [B,Sq,H,dh], k [B,Sk,Kv,dh]: the
    roofline model's (``analysis.roofline``), for the cost analyzer."""
    B, Sq, H, dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    nbytes = rl.flash_kernel_bytes(B=B, H=H, Kv=Kv, Sq=Sq, Sk=Sk, dh=dh,
                                   dtype_bytes=q.element_size())
    return rl.flash_kernel_flops(B=B, H=H, Sq=Sq, Sk=Sk, dh=dh,
                                 causal=causal), nbytes


LIBRARY = CudaLibrary("flash_prefill",
                      Path(__file__).with_name("csrc") / "flash_prefill.cu",
                      _bind)
KERNEL = CudaKernel("flash_attention", LIBRARY, launch_cost)     # B5


def smem_bytes(dh: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one block of the instance for ``dtype``.  bf16: the
    q rows and the ring of K and V tiles, each 128 columns wide (dh
    zero-padded: the swizzled layout wgmma reads), plus 1 KB to align them
    on the swizzle atoms.  f32: the query rows, the K and V tiles and the
    probabilities, with the source's padded strides."""
    rows, keys = TILES[dtype]
    if dtype == torch.bfloat16:
        return 1024 + (rows + KV_STAGES * 2 * keys) * MAX_DH * 2
    return 4 * (rows * (dh + 4) + 2 * keys * (dh + 1) + rows * (keys + 1))


def precheck(*, B: int, H: int, Kv: int, Sq: int, Sk: int, dh: int,
             block_q: int = 256, block_k: int = 256,
             dtype: torch.dtype = torch.bfloat16) -> Dict[str, object]:
    """Static launch validation (the port of the TPU kernel's ``precheck``,
    ``flash_prefill.py:42``: the same divisibility and head-group errors,
    with the VMEM budget replaced by the shared memory of a Hopper block of
    the instance for ``dtype``).  Returns ``{"errors": [...],
    "smem_bytes": int}``."""
    errors: List[str] = []
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if bq <= 0 or Sq % bq:
        errors.append(f"Sq={Sq} not divisible by query block bq={bq}")
    if bk <= 0 or Sk % bk:
        errors.append(f"Sk={Sk} not divisible by key block bk={bk}")
    if Kv <= 0 or H % Kv:
        errors.append(f"H={H} not divisible by Kv={Kv}: GQA head-group "
                      "index h // G would misalign KV tiles")
    if not 1 <= dh <= MAX_DH:
        errors.append(f"dh={dh} outside [1, {MAX_DH}]: the kernel's "
                      "accumulators cover at most 128 columns")
    smem = smem_bytes(dh, dtype)
    if smem > SMEM_PER_BLOCK:
        errors.append(f"shared memory {smem} B exceeds {SMEM_PER_BLOCK} B")
    return {"errors": errors, "smem_bytes": smem}


def _check(q, k, v, block_q: int, block_k: int) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)}: need "
                         "[B,Sq,H,dh] and [B,Sk,Kv,dh]")
    B, Sq, H, dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, Kv, dh) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: need "
                        f"one of {list(_TYPES)}, the same for all three")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    errs = precheck(B=B, H=H, Kv=Kv, Sq=Sq, Sk=Sk, dh=dh, block_q=block_q,
                    block_k=block_k, dtype=q.dtype)["errors"]
    if errs:
        raise ValueError("; ".join(errs))


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Sq, H, dh = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = KERNEL.lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_prefill_launch(
            _TYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Sq, Sk, H, Kv, dh, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL.name} launch failed: "
                           + lib.flash_prefill_error_string(err).decode())
    KERNEL.count_launch(q, k, causal)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 256,
                    block_k: int = 256) -> torch.Tensor:
    """GQA attention with the TPU kernel's top-left causal mask.  Launches
    the kernel for CUDA tensors, runs the plain twin for CPU tensors."""
    _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    return _launch(q, k, v, causal)
