"""CUDA-graph capture and replay per shape bucket: the port's stand-in for
``jax.jit``'s compiled executables.

The reference compiles one XLA executable per shape bucket of each engine
dispatch and replays it; here each bucket is one ``torch.cuda.CUDAGraph``.
A :class:`GraphSet` holds one engine's (or session's) graphs, keyed by
``(family, key)``, on ONE private memory pool:

  * capture: the bucket's static input buffers are filled with the
    dispatch's dead-lane operands (a no-op on the live state), the
    dispatch runs once eagerly on a side stream (it builds the kernel
    libraries and lets cuBLAS settle its workspace), then it is captured;
    no real operand ever runs at capture, so capturing mid-serve changes
    nothing;
  * replay: the caller's operands are ``copy_``-ed into the static
    buffers and the graph replays on the current stream.

State tensors (caches, page tables, params) are closed over by the
dispatch function: they must keep their storage for the graphs' lifetime
(anything that reallocates them calls :meth:`GraphSet.drop`).  A graph's
outputs live in the shared pool and are overwritten by the next replay of
ANY graph of the set, so callers consume them (or enqueue their copies)
before the next dispatch.

A bucket not yet captured is captured at its first dispatch, as
``jax.jit`` compiles at first call, and counts in ``lazy_captures``
unless a warmup is capturing (``warming``); every capture also counts
in ``repro_torch.obs.compile_events`` (the engine's
``serve_compile_total``).  A failed capture raises; nothing falls back to
eager.  Kernel launches
recorded during a capture (``CudaKernel.captured``) become the graph's
tally, added to each kernel's ``launches`` at every replay.

For the serve auditor (``analysis.lint.audit``), a set whose
``keep_census`` is on keeps each graph's description (``keep_graph=True``)
and hands it out as CUDA's DOT text (:meth:`GraphSet.dot`:
``cuGraphDebugDotPrint``), with the kernel tally of its capture
(:meth:`GraphSet.tally`).
"""
from __future__ import annotations

import ctypes
import gc
import os
import tempfile
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import KERNELS
from repro_torch.obs import compile_events


@dataclass
class _Graph:
    graph: Any                          # torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]          # static input buffers
    outputs: Any                        # static outputs (pool memory)
    tally: Dict[Any, int]               # kernel -> launches per replay


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class GraphSet:
    """The captured graphs of one engine or session on ``device``, with
    their counts: ``captures`` and ``lazy_captures`` (made at first use)
    and ``replays``, per family, and ``capture_s`` (wall time spent
    capturing, warm runs included)."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise RuntimeError(f"CUDA graphs need a CUDA device, not "
                               f"{device}; run eagerly (graphs=False) on "
                               "the CPU")
        self.device = device
        self._graphs: Dict[Tuple[str, Hashable], _Graph] = {}
        self._pool = torch.cuda.graph_pool_handle()
        self.captures: Counter = Counter()
        self.lazy_captures: Counter = Counter()
        self.replays: Counter = Counter()
        self.capture_s = 0.0
        self.warming = False            # set while a warmup captures
        self.keep_census = False        # keep graph descriptions (audit)

    def count(self, family: str) -> int:
        """Graphs held in ``family``."""
        return sum(f == family for f, _ in self._graphs)

    def keys(self, family: str) -> List[Hashable]:
        return [k for f, k in self._graphs if f == family]

    def drop(self) -> None:
        """Forget every graph (their storage returns to a fresh pool):
        called when state the graphs point into was reallocated."""
        self._graphs.clear()
        self._pool = torch.cuda.graph_pool_handle()

    def _record(self, fn: Callable, inputs: List[torch.Tensor]) -> _Graph:
        """One warm eager run on a side stream, then the capture."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(*inputs)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_census)
        before = {k: k.captured for k in KERNELS}
        # a collection mid-capture may free an unreachable engine's graphs,
        # and destroying a graph then invalidates this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                outputs = fn(*inputs)
        finally:
            if collecting:
                gc.enable()
        tally = {k: k.captured - before[k] for k in KERNELS
                 if k.captured != before[k]}
        return _Graph(graph, inputs, outputs, tally)

    def capture(self, family: str, key: Hashable, fn: Callable,
                dead_inputs: Sequence, lazy: bool = False) -> None:
        """Capture ``fn(*inputs)`` for one bucket; ``dead_inputs`` give the
        static buffers their shapes, dtypes and no-op contents."""
        t0 = time.perf_counter()
        inputs = [_as_tensor(x).to(self.device).clone() for x in dead_inputs]
        self._graphs[(family, key)] = self._record(fn, inputs)
        self.captures[family] += 1
        compile_events.record()
        if lazy:
            self.lazy_captures[family] += 1
        self.capture_s += time.perf_counter() - t0

    def run(self, family: str, key: Hashable, fn: Callable,
            inputs: Sequence, dead_inputs: Callable[[], Sequence]) -> Any:
        """Replay the bucket's graph on ``inputs`` (tensors or arrays,
        copied into the static buffers), capturing it first if it is new
        (``dead_inputs()`` gives its no-op operands).  Returns the graph's
        static outputs."""
        g = self._graphs.get((family, key))
        if g is None:
            self.capture(family, key, fn, dead_inputs(),
                         lazy=not self.warming)
            g = self._graphs[(family, key)]
        for buf, x in zip(g.inputs, inputs):
            buf.copy_(_as_tensor(x), non_blocking=True)
        g.graph.replay()
        for k, n in g.tally.items():
            k.launches += n
        self.replays[family] += 1
        return g.outputs

    def tally(self, family: str, key: Hashable) -> Dict[str, int]:
        """The kernel launches recorded while the bucket's graph was
        captured, by kernel name: what each replay launches."""
        g = self._graphs[(family, key)]
        return {k.name: n for k, n in g.tally.items()}

    def dot(self, family: str, key: Hashable) -> str:
        """CUDA's DOT description of the bucket's graph (its nodes:
        kernels with their symbols, memcpys with their direction, host
        nodes); needs ``keep_census`` on before the capture."""
        g = self._graphs[(family, key)]
        if not self.keep_census or not hasattr(g.graph, "raw_cuda_graph"):
            raise RuntimeError("graph descriptions are kept only when "
                               "keep_census is set before the capture")
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphDebugDotPrint.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p, ctypes.c_uint]
        lib.cuGraphDebugDotPrint.restype = ctypes.c_int
        fd, path = tempfile.mkstemp(suffix=".dot")
        os.close(fd)
        try:
            rc = lib.cuGraphDebugDotPrint(
                ctypes.c_void_p(g.graph.raw_cuda_graph()), path.encode(),
                0)                      # terse: node types, symbols, kinds
            if rc != 0:
                raise RuntimeError(f"cuGraphDebugDotPrint failed: {rc}")
            with open(path, "r", encoding="utf-8", errors="replace") as fh:
                return fh.read()
        finally:
            os.unlink(path)
