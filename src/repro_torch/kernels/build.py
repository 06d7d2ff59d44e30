"""Build and load the port's hand-written CUDA kernels.

Each kernel library is one ``csrc/*.cu`` file with a plain C interface
(it may hold several kernels, each with its own launch count); the
headers it shares with the others live in ``kernels/csrc/``.  At first
use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``<repo>/build/kernels/`` (listed in ``.gitignore``), named by a hash of the
source and the shared headers, and loaded with ``ctypes``; the ptxas
report of the build is kept beside it (``*.ptxas.log``).  Nothing is
built when a module is imported: the CPU tests import every module of the
port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, List, Optional

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
HEADER_DIR = Path(__file__).resolve().with_name("csrc")    # shared *.cuh


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class CudaLibrary:
    """One ``csrc/*.cu`` source built into one shared library: where its
    source is, how its C functions are typed (``bind``), and the ptxas
    report of the build of this exact source (``ptxas_log``, read back from
    beside the library when it was built earlier)."""

    def __init__(self, name: str, source: Path,
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = Path(source)
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode())
        for header in sorted(HEADER_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()
        return BUILD_DIR / f"{self.name}-{digest[:16]}.so"

    @property
    def ptxas_log(self) -> str:
        """The ptxas ``-v`` report of the built library ("" before a build)."""
        log = self.library_path().with_suffix(".ptxas.log")
        return log.read_text() if log.exists() else ""

    def build(self) -> Path:
        """Compile unless a library of this exact source exists; returns it."""
        out = self.library_path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(HEADER_DIR), "-Xptxas", "-v",
               "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{res.stderr}")
        tmp_log = tmp.with_suffix(".log.tmp")
        tmp_log.write_text(res.stderr)
        os.replace(tmp_log, out.with_suffix(".ptxas.log"))
        os.replace(tmp, out)                  # atomic: concurrent builds agree
        return out

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib


class CudaKernel:
    """One kernel the port launches, in a :class:`CudaLibrary` (several
    kernels may share one library), and how many times the port launched
    it (``launches``).  The wrapper calls :meth:`count_launch` at each
    launch and nowhere else.  A launch made while the stream is being
    captured into a CUDA graph only records the kernel into the graph, so
    it counts in ``captured`` instead; ``runtime.graphs`` adds a graph's
    recorded launches to ``launches`` at each replay.

    ``cost(*args)`` gives a launch's (flops, bytes) from the operands the
    wrapper hands to :meth:`count_launch`; a launch outside a capture is
    passed to ``CudaKernel.observer(kernel, args)`` while one is set (the
    cost analyzer, ``analysis.cost.CostMode``, sets it while it counts)."""

    observer: Optional[Callable[["CudaKernel", tuple], None]] = None

    def __init__(self, name: str, library: CudaLibrary,
                 cost: Optional[Callable[..., tuple]] = None):
        self.name = name
        self.library = library
        self.cost = cost
        self.launches = 0
        self.captured = 0

    def lib(self) -> ctypes.CDLL:
        return self.library.lib()

    def count_launch(self, *args) -> None:
        import torch
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            self.captured += 1
            return
        self.launches += 1
        if CudaKernel.observer is not None and self.cost is not None:
            CudaKernel.observer(self, args)


def build_all(kernels: Iterable[CudaKernel]) -> List[Path]:
    """Build the libraries of these kernels at once: one nvcc process per
    source, started together."""
    libs = list({id(k.library): k.library for k in kernels}.values())
    with ThreadPoolExecutor(max_workers=max(len(libs), 1)) as pool:
        return list(pool.map(lambda lib: lib.build(), libs))
