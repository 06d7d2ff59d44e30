"""Chunk-prefill sparse-prefix statistics: the CUDA kernels' wrappers.

``swan_chunk_stats`` has the contract of the TPU kernel
``swan_chunk_stats_pallas`` (``repro/kernels/flash_prefill/swan_chunk.py:196``):
Q = C·G chunk queries ``q [P,Kv,Q,dh]`` (f32) against the valid prefix
``t < sp_len [P]`` of the packed sparse cache [P,Kv,S,k], returned as the
mergeable partial stats (m_safe [P,Kv,Q], l [P,Kv,Q], o_unnorm
[P,Kv,Q,dh]), all f32, ``m_safe = 0`` where nothing was valid.
``swan_chunk_stats_paged`` has the contract of
``swan_chunk_stats_paged_pallas`` (same file :241): the prefix lives in a
page pool [n_pages,Kv,ps,k] read through the lanes' page-table rows
``page_rows [P, Pg]``.

For CUDA tensors they launch ``csrc/swan_chunk.cu`` (one block per (query
tile, kv head, lane), one body for both layouts; see the note at the top
of that file) or raise; for CPU tensors they run the plain twins in
``ref.py``.  The source has two bodies, picked by the value type: bf16,
int8 and fp8 values on tensor cores (128 queries a block, packed tiles of
64 rows expanded to bf16, q split into two bf16 parts, three for int8,
and p into two), f32 values on CUDA cores (64 queries a block, tiles of
32 rows in f32).
Arguments are checked the same way on both devices.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.kernels.build import CudaKernel, CudaLibrary
from repro_torch.kernels.swan_chunk.ref import (
    swan_chunk_stats_paged_reference, swan_chunk_stats_reference)

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# the plain PyTorch versions of the kernels' functions
swan_chunk_stats_plain = swan_chunk_stats_reference
swan_chunk_stats_paged_plain = swan_chunk_stats_paged_reference

_V_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}
# (queries per block, packed rows per tile) of each body: tc::kQT, tc::kBS
# and f32::kQT, f32::kBS in the CUDA source
TILES = {"tensor_core": (128, 64), "f32": (64, 32)}
SMEM_PER_BLOCK = 232448                  # bytes a block may use on sm_90
MAX_DH = 128                             # accumulator columns a query holds


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.swan_chunk_launch.argtypes = [i] + [p] * 12 + [i] * 8 + [p]
    lib.swan_chunk_launch.restype = i
    lib.swan_chunk_error_string.argtypes = [i]
    lib.swan_chunk_error_string.restype = ctypes.c_char_p


def launch_cost(q, k_vals, sp_len, S: int) -> Tuple[float, int]:
    """(flops, bytes) of one launch on q [P,Kv,Q,dh] over the packed rows
    it reads, min(sp_len[p], S) for each lane, of ``k_vals``' width and
    type: the roofline model's (``analysis.roofline``).  Reads ``sp_len``
    to the host: the cost analyzer calls it, at each launch it counts."""
    P, Kv, Q, dh = q.shape
    k = k_vals.shape[3]
    rows = int(sp_len.clamp(0, S).sum())
    nbytes = rl.swan_chunk_kernel_bytes(
        B=P, Kv=Kv, Q=Q, dh=dh, S=S, k_max=k,
        quantized=k_vals.dtype == torch.int8,
        val_bytes=k_vals.element_size(), rows=rows)
    return rl.swan_chunk_kernel_flops(B=P, Kv=Kv, Q=Q, S=S, k_max=k,
                                      rows=rows), nbytes


LIBRARY = CudaLibrary("swan_chunk",
                      Path(__file__).with_name("csrc") / "swan_chunk.cu", _bind)
KERNEL = CudaKernel("swan_chunk_stats", LIBRARY, launch_cost)       # B3
KERNEL_PAGED = CudaKernel("swan_chunk_stats_paged", LIBRARY,
                          launch_cost)                              # B4


def smem_bytes(dh: int, k_max: int,
               v_dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one block of the body for ``v_dtype``.  Tensor
    cores (bf16, int8, fp8): the expanded bf16 k and v tiles (dh padded to
    a multiple of 16, plus 8 columns against ldmatrix bank conflicts), the
    q tile as two bf16 parts (three for int8) with the same rows, and two
    staging buffers of packed rows (vals, idx and scales of both sides,
    each region rounded up to 16 bytes).  f32: the q tile, the expanded k
    and v tiles and the probabilities, with the source's padded strides."""
    a16 = lambda n: -(-n // 16) * 16  # noqa: E731
    if v_dtype == torch.float32:
        q_t, rows = TILES["f32"]
        return 4 * (q_t * (dh + 4) + 2 * rows * (dh + 1) + q_t * (rows + 1))
    q_t, rows = TILES["tensor_core"]
    vb = torch.empty((), dtype=v_dtype).element_size()
    stage = 2 * (a16(rows * k_max * vb) + a16(rows * k_max) + rows * 4)
    q_parts = 3 if v_dtype == torch.int8 else 2
    return (2 * rows + q_parts * q_t) * (a16(dh) + 8) * 2 + 2 * stage


def precheck(*, dh: int, k_max: int, S: int,
             v_dtype: torch.dtype = torch.bfloat16) -> Dict[str, object]:
    """Static launch validation (the port of the TPU kernel's ``precheck``,
    ``swan_chunk.py:59``, budgeted against the shared memory of a Hopper
    block of the body for ``v_dtype``).  ``S`` is the sparse extent
    (``Pg * page_size`` for the paged kernel).  Returns ``{"errors":
    [...], "smem_bytes": int}``."""
    errors: List[str] = []
    if S <= 0:
        errors.append(f"empty sparse extent S={S}: the caller must "
                      "short-circuit to zero stats")
    if not 1 <= k_max <= dh:
        errors.append(f"k_max={k_max} must lie in [1, dh={dh}]")
    if dh > MAX_DH:
        errors.append(f"dh={dh} > {MAX_DH}: the kernel's accumulators and "
                      "int8 indices cover at most 128 columns")
    smem = smem_bytes(dh, k_max, v_dtype)
    if smem > SMEM_PER_BLOCK:
        errors.append(f"shared memory {smem} B exceeds {SMEM_PER_BLOCK} B")
    return {"errors": errors, "smem_bytes": smem}


def _check(q, k_vals, k_idx, v_vals, v_idx, sp_len, k_scale, v_scale,
           page_rows=None) -> int:
    """Validate the operands; returns the sparse extent S (slab rows, or
    Pg · page_size)."""
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} is not [P,Kv,Q,dh]")
    P, Kv, Q, dh = q.shape
    lead = (P, Kv) if page_rows is None else (k_vals.shape[0], Kv)
    if k_vals.dim() != 4 or k_vals.shape[:2] != lead:
        raise ValueError(f"k_vals {tuple(k_vals.shape)} does not match q "
                         f"{tuple(q.shape)}")
    R, k = k_vals.shape[2], k_vals.shape[3]
    shapes = {"k_idx": (k_idx, (*lead, R, k)), "v_vals": (v_vals, (*lead, R, k)),
              "v_idx": (v_idx, (*lead, R, k)), "sp_len": (sp_len, (P,))}
    if k_scale is not None or v_scale is not None:
        shapes["k_scale"] = (k_scale, (*lead, R))
        shapes["v_scale"] = (v_scale, (*lead, R))
    S = R
    if page_rows is not None:
        if page_rows.dim() != 2 or page_rows.shape[1] < 1:
            raise ValueError(f"page_rows {tuple(page_rows.shape)}: need "
                             "[P, Pg] with Pg >= 1")
        shapes["page_rows"] = (page_rows, (P, page_rows.shape[1]))
        S = page_rows.shape[1] * R
    for name, (t, want) in shapes.items():
        if t is None or tuple(t.shape) != want:
            got = None if t is None else tuple(t.shape)
            raise ValueError(f"{name}: shape {got}, expected {want}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32 (the kernel's query tile), got "
                        f"{q.dtype}")
    if k_vals.dtype != v_vals.dtype or k_vals.dtype not in _V_TYPES:
        raise TypeError(f"k/v_vals dtype {k_vals.dtype}/{v_vals.dtype} not "
                        f"one of {list(_V_TYPES)}")
    if (k_vals.dtype == torch.int8) != (k_scale is not None):
        raise TypeError("int8 values need k_scale/v_scale, and only they do")
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or v_scale.dtype != torch.float32):
        raise TypeError("k_scale/v_scale must be float32")
    if k_idx.dtype != torch.int8 or v_idx.dtype != torch.int8:
        raise TypeError("k_idx/v_idx must be int8")
    if sp_len.dtype != torch.int32:
        raise TypeError("sp_len must be int32")
    if page_rows is not None and page_rows.dtype != torch.int32:
        raise TypeError("page_rows must be int32")
    tensors = [q, k_vals, k_idx, v_vals, v_idx, sp_len] + [
        t for t in (k_scale, v_scale, page_rows) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on q's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    errs = precheck(dh=dh, k_max=k, S=S, v_dtype=k_vals.dtype)["errors"]
    if errs:
        raise ValueError("; ".join(errs))
    return S


def _launch(kernel: CudaKernel, q, k_vals, k_idx, v_vals, v_idx, sp_len,
            k_scale, v_scale, page_rows, S: int) -> Stats:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    P, Kv, Q, dh = q.shape
    ps, n_pages = ((0, 0) if page_rows is None
                   else (k_vals.shape[2], k_vals.shape[0]))
    m = torch.empty((P, Kv, Q), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    o = torch.empty((P, Kv, Q, dh), dtype=torch.float32, device=q.device)
    lib = kernel.lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.swan_chunk_launch(
            _V_TYPES[k_vals.dtype], q.data_ptr(), k_vals.data_ptr(),
            k_idx.data_ptr(), v_vals.data_ptr(), v_idx.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            sp_len.data_ptr(),
            None if page_rows is None else page_rows.data_ptr(),
            m.data_ptr(), l.data_ptr(), o.data_ptr(),
            P, Kv, Q, dh, S, k_vals.shape[3], ps, n_pages, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} launch failed: "
                           + lib.swan_chunk_error_string(err).decode())
    kernel.count_launch(q, k_vals, sp_len, S)
    return m, l, o


def swan_chunk_stats(q: torch.Tensor, k_vals: torch.Tensor,
                     k_idx: torch.Tensor, v_vals: torch.Tensor,
                     v_idx: torch.Tensor, sp_len: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> Stats:
    """Sparse-prefix stats of the chunk queries over a slab [P,Kv,S,k].
    Launches the kernel for CUDA tensors, runs the plain twin for CPU
    tensors."""
    S = _check(q, k_vals, k_idx, v_vals, v_idx, sp_len, k_scale, v_scale)
    if q.device.type == "cpu":
        return swan_chunk_stats_plain(q, k_vals, k_idx, v_vals, v_idx, sp_len,
                                      k_scale, v_scale)
    return _launch(KERNEL, q, k_vals, k_idx, v_vals, v_idx, sp_len, k_scale,
                   v_scale, None, S)


def swan_chunk_stats_paged(q: torch.Tensor, pool_k_vals: torch.Tensor,
                           pool_k_idx: torch.Tensor, pool_v_vals: torch.Tensor,
                           pool_v_idx: torch.Tensor, sp_len: torch.Tensor,
                           page_rows: torch.Tensor,
                           pool_k_scale: Optional[torch.Tensor] = None,
                           pool_v_scale: Optional[torch.Tensor] = None
                           ) -> Stats:
    """Sparse-prefix stats over a page pool [n_pages,Kv,ps,k] read through
    ``page_rows [P, Pg]`` int32.  Launches the kernel for CUDA tensors,
    runs the plain twin for CPU tensors."""
    S = _check(q, pool_k_vals, pool_k_idx, pool_v_vals, pool_v_idx, sp_len,
               pool_k_scale, pool_v_scale, page_rows)
    if q.device.type == "cpu":
        return swan_chunk_stats_paged_plain(q, pool_k_vals, pool_k_idx,
                                            pool_v_vals, pool_v_idx, sp_len,
                                            page_rows, pool_k_scale,
                                            pool_v_scale)
    return _launch(KERNEL_PAGED, q, pool_k_vals, pool_k_idx, pool_v_vals,
                   pool_v_idx, sp_len, pool_k_scale, pool_v_scale, page_rows,
                   S)
