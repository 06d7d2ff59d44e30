"""Process-wide CUDA-graph capture accounting: the port's counterpart of
``repro.obs.compile_events``.

The reference counts XLA backend compiles through a ``jax.monitoring``
listener; a warm jit cache compiles nothing.  The port compiles nothing at
run time: what a mid-serve XLA compile costs the reference, a CUDA-graph
capture at a bucket's first dispatch costs the port (a warm run and a
capture of a whole model step).  So this counter is bumped by
``runtime.graphs.GraphSet.capture`` — once per captured graph, and by
nothing else.  An eager engine therefore counts 0, as a warm jit cache
does.

* ``ServeEngine`` brackets every dispatch with :func:`total` and feeds
  the delta into ``serve_compile_total{phase="serve"}``, so a capture in
  the middle of serving shows in the metrics when it happens;
* ``runtime.warmup`` counts its captures into
  ``serve_compile_total{phase="warmup"}``, and ``bench_warmup`` gates
  "zero captures after ``warmup()``" on the same counter.

The counter is process-global and monotonic: consumers difference it.
"""
from __future__ import annotations

# the help text of the ``serve_compile_total`` family that counts them
METRIC_HELP = "CUDA-graph captures by phase (warmup vs mid-serve)"

_total = 0


def install() -> None:
    """Nothing to register (``GraphSet.capture`` calls :func:`record`);
    kept so that call sites read as the reference's."""


def record(n: int = 1) -> None:
    """Count ``n`` graph captures."""
    global _total
    _total += n


def total() -> int:
    """Graph captures in this process so far (monotonic)."""
    return _total
