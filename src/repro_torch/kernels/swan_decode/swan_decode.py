"""SWAN hybrid-cache decode attention: the CUDA kernels' wrappers.

``swan_decode`` has the contract of the TPU kernel ``swan_decode_pallas``
(``repro/kernels/swan_decode/swan_decode.py:196``): q [B,Kv,G,dh] attends
over the packed sparse prefix [B,Kv,S,k] (rows ``t < sp_len``) and the
dense ring [B,Kv,b,dh] (slots ``0 <= buf_pos <= pos``) with one softmax,
and returns o [B,Kv,G,dh] in q's dtype.  ``swan_decode_paged`` has the
contract of ``swan_decode_paged_pallas`` (same file :266): the packed
prefix lives in a page pool [n_pages,Kv,ps,k] and sequence ``b``'s logical
row ``t`` is row ``t % ps`` of page ``page_tab[b, t // ps]``.

For CUDA tensors they launch ``csrc/swan_decode.cu`` (split-S: one block
per (sequence, kv head) and 256-row split of the packed prefix, one more
for the ring, then a merge kernel over the splits in a fixed order; one
body for both layouts; see the note at the top of that file) or raise;
for CPU tensors they run the plain twins (``swan_decode_reference``, after
``gather_pages`` for the pool).  The wrapper allocates the splits' f32
workspace; the launch reads nothing back to the host.
Arguments are checked the same way on both devices.

The CUDA source holds instances for query groups of 1, 2, 4 and 8 heads
(``INSTANCES``); the TPU kernel takes any G.  ``g_plan`` maps any G >= 1
onto them: G <= 8 pads q with zero query rows up to the next instance
(3 -> 4; 5, 6, 7 -> 8), and G > 8 is cut into ceil(G / 8) equal groups of
consecutive heads, one launch each over the same cache.  A zero query row
scores 0 on every key, so its (discarded) output stays finite and the
real rows are untouched: each row's softmax is its own.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.core.hybrid_cache import per_seq_pos
from repro_torch.core.swan_attention import gather_pages
from repro_torch.kernels.build import CudaKernel, CudaLibrary
from repro_torch.kernels.swan_decode.ref import swan_decode_reference

# the plain PyTorch version of the slab kernel's function
swan_decode_plain = swan_decode_reference


def swan_decode_paged_plain(q, pool_k_vals, pool_k_idx, pool_v_vals,
                            pool_v_idx, buf_k, buf_v, buf_pos, pos, sp_len,
                            page_tab, pool_k_scale=None, pool_v_scale=None):
    """The plain PyTorch version of the paged kernel's function: gather
    each sequence's logical rows from the pool, then the slab twin."""
    g = lambda x: None if x is None else gather_pages(x, page_tab)  # noqa: E731
    return swan_decode_reference(q, g(pool_k_vals), g(pool_k_idx),
                                 g(pool_v_vals), g(pool_v_idx), buf_k, buf_v,
                                 buf_pos, pos, sp_len, g(pool_k_scale),
                                 g(pool_v_scale))

_Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_V_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}
INSTANCES = (1, 2, 4, 8)                 # the G instances of the CUDA source
# mirrors of the CUDA source's constants
N_WARPS = 8                              # kWarps
TILE_ROWS = 32                           # kTile: packed rows per staged tile
STAGES = 2                               # kStages: staging buffers
SPLIT_ROWS = 256                         # kSplitRows: prefix rows per split
MAX_GRID_Y = 65535                       # splits + 1 per launch
SMEM_PER_BLOCK = 232448                  # bytes a block may use on sm_90
MAX_DH = 128                             # int8 indices address dh <= 128 columns


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.swan_decode_launch.argtypes = ([i, i] + [p] * 15 + [ctypes.c_longlong]
                                       + [i] * 9 + [p])
    lib.swan_decode_launch.restype = i
    lib.swan_decode_error_string.argtypes = [i]
    lib.swan_decode_error_string.restype = ctypes.c_char_p


def launch_cost(q, k_vals, buf_k, sp_len, S: int) -> Tuple[float, int]:
    """(flops, bytes) of one launch on q [B,Kv,G,dh] over the packed rows
    it reads, min(sp_len[b], S) for each sequence, of ``k_vals``' width and
    type, and the ring ``buf_k``: the roofline model's
    (``analysis.roofline``).  Reads ``sp_len`` to the host: the cost
    analyzer calls it, at each launch it counts."""
    B, Kv, G, dh = q.shape
    k, b = k_vals.shape[3], buf_k.shape[2]
    rows = int(sp_len.clamp(0, S).sum())
    nbytes = rl.swan_decode_kernel_bytes(
        B=B, Kv=Kv, G=G, dh=dh, S=S, k_max=k, buffer=b,
        quantized=k_vals.dtype == torch.int8,
        val_bytes=k_vals.element_size(), act_bytes=q.element_size(),
        rows=rows)
    flops = rl.swan_decode_kernel_flops(B=B, Kv=Kv, G=G, dh=dh, S=S,
                                        k_max=k, buffer=b, rows=rows)
    return flops, nbytes


LIBRARY = CudaLibrary("swan_decode",
                      Path(__file__).with_name("csrc") / "swan_decode.cu", _bind)
KERNEL = CudaKernel("swan_decode", LIBRARY, launch_cost)        # slab (B1)
KERNEL_PAGED = CudaKernel("swan_decode_paged", LIBRARY,
                          launch_cost)                          # pool (B2)


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def g_plan(G: int) -> Tuple[int, int, int]:
    """How the kernels serve a query group of ``G`` heads: ``(instance,
    groups, per)`` -- ``groups`` launches of the CUDA instance ``instance``
    (one of ``INSTANCES``), launch ``j`` over query heads ``[j*per,
    min((j+1)*per, G))`` with zero rows padding it to ``instance``."""
    if G < 1:
        raise ValueError(f"query group G={G} must be >= 1")
    groups = -(-G // INSTANCES[-1])
    per = -(-G // groups)
    return next(i for i in INSTANCES if i >= per), groups, per


def run_grouped(q: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor]
                ) -> torch.Tensor:
    """``fn`` (one launch on q [B,Kv,instance,dh]) applied by ``g_plan``:
    q's heads padded with zero rows and cut into groups, one call each,
    and the outputs' real rows put back as [B,Kv,G,dh].  An instance's own
    G is one call on q itself."""
    B, Kv, G, dh = q.shape
    inst, groups, per = g_plan(G)
    if inst == G:
        return fn(q)
    if groups == 1:                     # G <= 8: one launch, zero rows below
        qp = q.new_zeros((B, Kv, inst, dh))
        qp[:, :, :G] = q
        return fn(qp)[:, :, :G]
    flat = q.new_zeros((B, Kv, groups * per, dh))
    flat[:, :, :G] = q
    qp = q.new_zeros((groups, B, Kv, inst, dh))
    qp[:, :, :, :per] = flat.view(B, Kv, groups, per, dh).permute(2, 0, 1, 3, 4)
    out = torch.stack([fn(qp[j]) for j in range(groups)])[:, :, :, :per]
    return out.permute(1, 2, 0, 3, 4).reshape(B, Kv, groups * per, dh)[:, :, :G]


def smem_bytes(G: int, dh: int, b: int, k: int, v_dtype: torch.dtype) -> int:
    """Shared memory of one decode block (mirrors ``Smem`` in the CUDA
    source): q̂ [dh][G], the warps' dense value rows [8][4][dh], (m, l)
    and the tile scores, then one region used in turn: a prefix split's
    two staging buffers (32 packed rows of k and v values, indices and
    scales) or the ring split's scores [G][b], and the warps' accumulators
    [8][dh][G] for the block's merge."""
    vb = v_dtype.itemsize
    stage = 2 * (_a16(TILE_ROWS * k * vb) + _a16(TILE_ROWS * k) + TILE_ROWS * 4)
    rows_per_warp = TILE_ROWS // N_WARPS
    row_stride = (dh + 3) // 4 * 4
    return (_a16(4 * G * dh) + 4 * N_WARPS * rows_per_warp * row_stride
            + _a16(4 * 2 * N_WARPS * G) + _a16(4 * N_WARPS * rows_per_warp * G)
            + max(STAGES * stage, _a16(4 * G * b), 4 * N_WARPS * G * dh))


def n_splits(S: int) -> int:
    """Prefix splits of a launch over S logical rows (the ring is one more)."""
    return -(-S // SPLIT_ROWS)


def merge_smem_bytes(G: int, S: int) -> int:
    """Shared memory of one merge block (mirrors ``merge_smem`` in the CUDA
    source): every split's max and weight per query, and the ring's."""
    return 4 * (2 * n_splits(S) + 3) * G


def workspace_bytes(B: int, Kv: int, G: int, dh: int, S: int) -> int:
    """The f32 partials (acc [dh][G], m [G], l [G]) of every split of every
    (sequence, kv head): the workspace the wrapper allocates per launch."""
    return 4 * B * Kv * (n_splits(S) + 1) * G * (dh + 2)


def precheck(*, G: int, dh: int, k_max: int, b: int, v_dtype: torch.dtype,
             S: int) -> Dict[str, object]:
    """Static launch validation (the port of the TPU kernel's ``precheck``,
    budgeted against a Hopper block's shared memory for ``v_dtype`` values).
    ``S`` is the sparse extent (``Pg * page_size`` for the paged kernel): it
    sets the number of splits, so the grid and the merge kernel's shared
    memory.  Any G >= 1 is served by ``g_plan``: the budget is that of its
    instance.  Returns ``{"errors": [...], "instance": int, "groups": int,
    "smem_bytes": int, "merge_smem_bytes": int, "workspace_bytes": int}``,
    the workspace per (sequence, kv head) over all the groups' launches."""
    errors: List[str] = []
    if not 1 <= k_max <= dh:
        errors.append(f"k_max={k_max} must lie in [1, dh={dh}]")
    if dh > MAX_DH:
        errors.append(f"dh={dh} > {MAX_DH}: int8 indices cannot address it")
    if G < 1:
        errors.append(f"query group G={G} must be >= 1")
        return {"errors": errors}
    inst, groups, _ = g_plan(G)
    if b < 1:
        errors.append("empty ring (b=0): the kernel needs b >= 1")
    if n_splits(S) + 1 > MAX_GRID_Y:
        errors.append(f"S={S} needs {n_splits(S) + 1} splits > {MAX_GRID_Y}")
    smem = smem_bytes(inst, dh, b, k_max, v_dtype)
    if smem > SMEM_PER_BLOCK:
        errors.append(f"shared memory {smem} B exceeds {SMEM_PER_BLOCK} B "
                      f"(G={G} as {groups} x {inst}, dh={dh}, b={b}, "
                      f"k={k_max}, {v_dtype})")
    merge = merge_smem_bytes(inst, S)
    if merge > SMEM_PER_BLOCK:
        errors.append(f"the merge kernel's shared memory {merge} B exceeds "
                      f"{SMEM_PER_BLOCK} B (G={G} as {groups} x {inst}, "
                      f"{n_splits(S)} splits)")
    return {"errors": errors, "instance": inst, "groups": groups,
            "smem_bytes": smem, "merge_smem_bytes": merge,
            "workspace_bytes": groups * workspace_bytes(1, 1, inst, dh, S)}


def _check(q, k_vals, k_idx, v_vals, v_idx, buf_k, buf_v, buf_pos, pos,
           sp_len, k_scale, v_scale, page_tab=None) -> None:
    """Validate the operands; the sparse leaves are [B,Kv,S,k] (slab) or,
    with ``page_tab [B, Pg]``, a pool [n_pages,Kv,ps,k]."""
    B, Kv, G, dh = q.shape
    lead = (B, Kv) if page_tab is None else (k_vals.shape[0], Kv)
    if k_vals.dim() != 4 or k_vals.shape[:2] != lead:
        raise ValueError(f"k_vals {tuple(k_vals.shape)} is not "
                         f"{'[B,Kv,S,k]' if page_tab is None else '[n_pages,Kv,ps,k]'}"
                         f" for q {tuple(q.shape)}")
    R, k = k_vals.shape[2], k_vals.shape[3]
    b = buf_k.shape[2] if buf_k.dim() == 4 else -1
    shapes = {"k_idx": (k_idx, (*lead, R, k)), "v_vals": (v_vals, (*lead, R, k)),
              "v_idx": (v_idx, (*lead, R, k)), "buf_k": (buf_k, (B, Kv, b, dh)),
              "buf_v": (buf_v, (B, Kv, b, dh)), "buf_pos": (buf_pos, (B, b)),
              "pos": (pos, (B,)), "sp_len": (sp_len, (B,))}
    if k_scale is not None or v_scale is not None:
        shapes["k_scale"] = (k_scale, (*lead, R))
        shapes["v_scale"] = (v_scale, (*lead, R))
    if page_tab is not None:
        if page_tab.dim() != 2 or page_tab.shape[1] < 1:
            raise ValueError(f"page_tab {tuple(page_tab.shape)}: need [B, Pg] "
                             "with Pg >= 1 (ship at least one page)")
        shapes["page_tab"] = (page_tab, (B, page_tab.shape[1]))
    for name, (t, want) in shapes.items():
        if t is None or tuple(t.shape) != want:
            got = None if t is None else tuple(t.shape)
            raise ValueError(f"{name}: shape {got}, expected {want}")
    if q.dtype not in _Q_TYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_TYPES)}")
    if buf_k.dtype != q.dtype or buf_v.dtype != q.dtype:
        raise TypeError("buf_k/buf_v must have q's dtype")
    if k_vals.dtype != v_vals.dtype or k_vals.dtype not in _V_TYPES:
        raise TypeError(f"k/v_vals dtype {k_vals.dtype}/{v_vals.dtype} not "
                        f"one of {list(_V_TYPES)}")
    if k_vals.dtype not in (q.dtype, torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"vals dtype {k_vals.dtype} must be q's dtype, int8 "
                        "or float8_e4m3fn")
    if (k_vals.dtype == torch.int8) != (k_scale is not None):
        raise TypeError("int8 values need k_scale/v_scale, and only they do")
    if k_scale is not None and (k_scale.dtype != torch.float32
                                or v_scale.dtype != torch.float32):
        raise TypeError("k_scale/v_scale must be float32")
    if k_idx.dtype != torch.int8 or v_idx.dtype != torch.int8:
        raise TypeError("k_idx/v_idx must be int8")
    if buf_pos.dtype != torch.int32:
        raise TypeError("buf_pos must be int32")
    if page_tab is not None and page_tab.dtype != torch.int32:
        raise TypeError("page_tab must be int32")
    tensors = [q, k_vals, k_idx, v_vals, v_idx, buf_k, buf_v, buf_pos, pos,
               sp_len] + [t for t in (k_scale, v_scale, page_tab)
                          if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all operands must be on q's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all operands must be contiguous")
    S = R if page_tab is None else page_tab.shape[1] * R
    errs = precheck(G=G, dh=dh, k_max=k, b=b, v_dtype=k_vals.dtype,
                    S=S)["errors"]
    if errs:
        raise ValueError("; ".join(errs))


def _launch(kernel: CudaKernel, q, k_vals, k_idx, v_vals, v_idx, buf_k,
            buf_v, buf_pos, pos, sp_len, k_scale, v_scale,
            page_tab) -> torch.Tensor:
    """Launch the decode kernels (splits, then their merge) on q's stream
    (slab when ``page_tab`` is None) once per group of ``g_plan``, each
    with a workspace from ``torch.empty`` on that stream; raises on a
    refused launch and counts each launch."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return run_grouped(q, lambda qg: _launch_one(
        kernel, qg, k_vals, k_idx, v_vals, v_idx, buf_k, buf_v, buf_pos, pos,
        sp_len, k_scale, v_scale, page_tab))


def _launch_one(kernel: CudaKernel, q, k_vals, k_idx, v_vals, v_idx, buf_k,
                buf_v, buf_pos, pos, sp_len, k_scale, v_scale,
                page_tab) -> torch.Tensor:
    """One launch of the instance of q's G (one of ``INSTANCES``)."""
    B, Kv, G, dh = q.shape
    k = k_vals.shape[3]
    if page_tab is None:
        S, ps, n_pages = k_vals.shape[2], 0, 0
    else:
        ps, n_pages = k_vals.shape[2], k_vals.shape[0]
        S = page_tab.shape[1] * ps
    out = torch.empty_like(q)
    ws_bytes = workspace_bytes(B, Kv, G, dh, S)
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32, device=q.device)
    lib = kernel.lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.swan_decode_launch(
            _Q_TYPES[q.dtype], _V_TYPES[k_vals.dtype], q.data_ptr(),
            k_vals.data_ptr(), k_idx.data_ptr(), v_vals.data_ptr(),
            v_idx.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            buf_k.data_ptr(), buf_v.data_ptr(), buf_pos.data_ptr(),
            pos.data_ptr(), sp_len.data_ptr(),
            None if page_tab is None else page_tab.data_ptr(), out.data_ptr(),
            ws.data_ptr(), ws_bytes, B, Kv, G, dh, S, k, buf_k.shape[2], ps,
            n_pages, stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name} launch failed: "
                           + lib.swan_decode_error_string(err).decode())
    kernel.count_launch(q, k_vals, buf_k, sp_len, S)
    return out


def swan_decode(q: torch.Tensor, k_vals: torch.Tensor, k_idx: torch.Tensor,
                v_vals: torch.Tensor, v_idx: torch.Tensor, buf_k: torch.Tensor,
                buf_v: torch.Tensor, buf_pos: torch.Tensor,
                pos: Union[int, torch.Tensor], sp_len: Union[int, torch.Tensor],
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over [packed sparse ‖ ring]; ``pos``/``sp_len`` are
    scalars or per-sequence [B].  Launches the kernel for CUDA tensors,
    runs the plain twin for CPU tensors."""
    B = q.shape[0]
    pos = per_seq_pos(pos, B, q.device)
    sp_len = per_seq_pos(sp_len, B, q.device)
    _check(q, k_vals, k_idx, v_vals, v_idx, buf_k, buf_v, buf_pos, pos,
           sp_len, k_scale, v_scale)
    if q.device.type == "cpu":
        return swan_decode_plain(q, k_vals, k_idx, v_vals, v_idx, buf_k,
                                 buf_v, buf_pos, pos, sp_len, k_scale, v_scale)
    return _launch(KERNEL, q, k_vals, k_idx, v_vals, v_idx, buf_k, buf_v,
                   buf_pos, pos, sp_len, k_scale, v_scale, None)


def swan_decode_paged(q: torch.Tensor, pool_k_vals: torch.Tensor,
                      pool_k_idx: torch.Tensor, pool_v_vals: torch.Tensor,
                      pool_v_idx: torch.Tensor, buf_k: torch.Tensor,
                      buf_v: torch.Tensor, buf_pos: torch.Tensor,
                      pos: Union[int, torch.Tensor],
                      sp_len: Union[int, torch.Tensor], page_tab: torch.Tensor,
                      pool_k_scale: Optional[torch.Tensor] = None,
                      pool_v_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Decode attention over [paged packed sparse ‖ ring]: pool leaves
    [n_pages,Kv,ps,k], ``page_tab [B, Pg]`` int32 (unmapped entries name
    the trash page, hidden by ``sp_len``).  Launches the kernel for CUDA
    tensors, runs the plain twin for CPU tensors."""
    B = q.shape[0]
    pos = per_seq_pos(pos, B, q.device)
    sp_len = per_seq_pos(sp_len, B, q.device)
    _check(q, pool_k_vals, pool_k_idx, pool_v_vals, pool_v_idx, buf_k, buf_v,
           buf_pos, pos, sp_len, pool_k_scale, pool_v_scale, page_tab)
    if q.device.type == "cpu":
        return swan_decode_paged_plain(q, pool_k_vals, pool_k_idx,
                                       pool_v_vals, pool_v_idx, buf_k, buf_v,
                                       buf_pos, pos, sp_len, page_tab,
                                       pool_k_scale, pool_v_scale)
    return _launch(KERNEL_PAGED, q, pool_k_vals, pool_k_idx, pool_v_vals,
                   pool_v_idx, buf_k, buf_v, buf_pos, pos, sp_len,
                   pool_k_scale, pool_v_scale, page_tab)
