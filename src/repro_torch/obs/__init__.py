"""repro_torch.obs — dependency-free serving observability, the port's
counterpart of ``repro.obs`` (its own copy: the port imports nothing of
the JAX package).

* :mod:`repro_torch.obs.metrics` — a :class:`MetricsRegistry` of
  counters, gauges and fixed-bucket histograms with Prometheus-text and
  JSON snapshot exporters, identical to the reference's.
* :mod:`repro_torch.obs.compile_events` — a process-global count of
  CUDA-graph captures (the port's "compiles"), bumped by
  ``runtime.graphs.GraphSet.capture``.  Backs the engine's
  ``serve_compile_total`` counter and every zero-capture gate.
* :mod:`repro_torch.obs.trace` — a structured JSONL event trace keyed by
  request uid and engine step, a wall-clock ``span`` helper, and a
  :class:`StepProfiler` that brackets N engine steps with
  ``torch.profiler``.

The contract the serve tests pin: metrics/tracing on vs off produces
IDENTICAL tokens and IDENTICAL dispatch counts — the subsystem observes
the engine, it never participates in it (tests/test_torch_obs_engine.py).
"""
from repro_torch.obs import compile_events
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, NULL_REGISTRY,
                                     NullRegistry, parse_prometheus)
from repro_torch.obs.trace import EventTrace, StepProfiler, span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL_REGISTRY", "parse_prometheus", "EventTrace", "StepProfiler",
    "span", "compile_events",
]
