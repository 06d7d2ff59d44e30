"""Fault-tolerant checkpointing in the reference's on-disk format (port of
``repro.checkpoint.checkpointer``): atomic, async, keep-last-k.

Layout (one directory per step):

    <dir>/step_00000123.tmp/...  (written)
    <dir>/step_00000123/         (atomic rename on completion)
        manifest.json            {step, paths, leaves: [{file, path, shape,
                                  dtype, crc}], version: 1}
        arr_00000.bin ...        one file of raw bytes per leaf

Leaves are stored in JAX's flatten order (dict keys sorted at every level)
under their ``/``-joined paths, so a checkpoint written by either package
restores in the other.  bfloat16 and float8_e4m3fn leaves are written as
their raw bits under the names ``"bfloat16"`` / ``"float8_e4m3fn"`` (the
names ml_dtypes gives them), so numpy needs no extension type here.

Guarantees: atomicity (tmp + rename; an interrupted save leaves only .tmp
litter, cleaned on the next save), integrity (CRC32 per leaf, verified on
restore), async (``save(..., blocking=False)`` copies every leaf to host
memory before it returns, then writes on a daemon thread, so the caller
may update its tensors in place at once), keep-k (old steps removed after
a successful save).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, unflatten

Tree = Any

# dtypes numpy lacks: name -> (torch dtype, torch and numpy integer dtypes
# of the same width)
_RAW_BITS = {"bfloat16": (torch.bfloat16, torch.int16, np.int16),
             "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8)}
_TORCH_NAME = {t: n for n, (t, *_) in _RAW_BITS.items()}


def _to_host(leaf: torch.Tensor) -> tuple:
    """(numpy array holding the leaf's bytes, dtype name for the
    manifest): a copy, never a view of the caller's tensor."""
    t = leaf.detach()
    name = _TORCH_NAME.get(t.dtype)
    if name is not None:
        t = t.view(_RAW_BITS[name][1])
    arr = t.to("cpu", copy=True).contiguous().numpy()
    return arr, name or str(arr.dtype)


def _from_bytes(raw: bytearray, name: str, shape) -> torch.Tensor:
    bits = _RAW_BITS.get(name)
    if bits is None:
        return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(name))
                                .reshape(shape))
    return torch.from_numpy(np.frombuffer(raw, dtype=bits[2])
                            .reshape(shape)).view(bits[0])


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Tree, blocking: bool = True) -> None:
        self.wait()   # one in-flight save at a time
        flat = flatten_with_path(tree)
        paths = [p for p, _ in flat]
        host = [_to_host(leaf) for _, leaf in flat]   # the snapshot
        if blocking:
            self._write(step, host, paths)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, paths),
                daemon=True)
            self._thread.start()

    def _write_guarded(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:   # surfaced on next wait()
            self._error = e

    def _write(self, step: int, host, paths) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "paths": paths, "leaves": [], "version": 1}
        for i, (arr, name) in enumerate(host):
            fn = f"arr_{i:05d}.bin"
            raw = memoryview(arr.reshape(-1).view(np.uint8))
            with open(os.path.join(tmp, fn), "wb") as f:
                f.write(raw)
            manifest["leaves"].append({
                "file": fn, "path": paths[i],
                "shape": list(arr.shape), "dtype": name,
                "crc": zlib.crc32(raw),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
        for d in os.listdir(self.dir):   # orphaned tmp from crashes
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Tree) -> Tree:
        """Restore into the structure of ``like``, a tree of tensors: each
        leaf looked up by its path in the manifest, its shape checked, cast
        to the dtype of and moved to the device of its ``like`` leaf.  A
        ``like`` that names a subset of the checkpoint's leaves restores
        that subset, so ``{"params": ...}`` restores the params of a
        trainer's ``{"params", "opt"}`` checkpoint."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {m["path"]: m for m in manifest["leaves"]}
        want = flatten_with_path(like)
        missing = [p for p, _ in want if p not in by_path]
        if missing:
            raise ValueError(f"leaf count mismatch: ckpt {len(by_path)} vs "
                             f"target {len(want)} ({len(missing)} target "
                             f"leaves not in the checkpoint, first "
                             f"{missing[0]!r})")
        metas = [by_path[p] for p, _ in want]
        arrays = []
        for meta in metas:
            path = os.path.join(d, meta["file"])
            raw = bytearray(os.path.getsize(path))
            with open(path, "rb") as f:
                f.readinto(raw)
            crc = zlib.crc32(raw)
            if crc != meta["crc"]:
                raise IOError(f"checkpoint corruption in {meta['path']}: "
                              f"crc {crc} != {meta['crc']}")
            arrays.append(_from_bytes(raw, meta["dtype"], meta["shape"]))
        for a, (_, l), meta in zip(arrays, want, metas):
            if tuple(a.shape) != tuple(l.shape):
                raise ValueError(f"shape mismatch at {meta['path']}: "
                                 f"{tuple(a.shape)} vs {tuple(l.shape)}")
        return unflatten(like, [a.to(device=l.device, dtype=l.dtype)
                                for a, (_, l) in zip(arrays, want)])
