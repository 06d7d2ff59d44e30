"""Structured JSONL event trace for the serving stack, plus host-timing
spans and a ``torch.profiler`` step hook.

The port's counterpart of ``repro.obs.trace``: :class:`EventTrace` and
:func:`span` are the reference's; :class:`StepProfiler` brackets N engine
steps with ``torch.profiler`` instead of ``jax.profiler``.

Every event is one JSON object per line::

    {"event": "admit", "step": 12, "uid": "req3", "slot": 1, "shard": 0,
     "prompt_len": 44, "k": 8, "mode": "chunked"}

``step`` is the ENGINE step at emit time — the deterministic scheduler
clock every serve metric is indexed by.  Every field is a plain Python
value taken from host state: reading a device tensor here would be a
host sync inside the serve loop.  Wall time enters only through the
explicit :func:`span` helper, which emits a ``span`` event carrying
``wall_ms`` measured strictly on the host around a ``with`` block.

The serve-engine event vocabulary: ``submit``, ``admit``,
``admission_hold``, ``chunk_dispatch``, ``prefill_complete``,
``first_token``, ``token``, ``decode_dispatch``, ``retire``, ``page_map``,
``page_free``, ``pool_grow``, ``pool_exhausted``, ``warmup_start``,
``warmup_done``, ``span``, ``profile_start``, ``profile_stop``.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional


class EventTrace:
    """JSONL event sink.  ``path`` appends one JSON line per event to a
    file (line-buffered, so a crash loses at most the current line);
    ``keep=True`` (the default when no path is given) also retains events
    in-memory on ``.events`` for tests and in-process consumers."""

    def __init__(self, path: Optional[str] = None,
                 keep: Optional[bool] = None):
        self.path = path
        self._fh = open(path, "w", buffering=1) if path else None
        self.keep = (path is None) if keep is None else keep
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: str, step: int, **fields: Any) -> None:
        rec = {"event": event, "step": int(step), **fields}
        if self.keep:
            self.events.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")

    def select(self, event: str, **match: Any) -> List[Dict[str, Any]]:
        """In-memory events of one type whose fields match ``match``."""
        return [e for e in self.events if e["event"] == event
                and all(e.get(k) == v for k, v in match.items())]

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "EventTrace":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        """Parse a JSONL trace file back into event dicts."""
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]


@contextmanager
def span(trace: Optional[EventTrace], name: str, step: int = 0,
         **fields: Any):
    """Wall-clock host-timing span: emits a ``span`` event with
    ``wall_ms`` on exit.  ``trace=None`` is a no-op (call sites stay
    unconditional).  A span around work on the card measures the host's
    enqueue time, not the device's: synchronise inside the block to time
    the device."""
    if trace is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        trace.emit("span", step=step, name=name,
                   wall_ms=(time.perf_counter() - t0) * 1e3, **fields)


class StepProfiler:
    """Bracket N engine steps with ``torch.profiler``.

    The engine calls :meth:`step_start` / :meth:`step_end` around every
    scheduler step; the first ``step_start`` starts the profiler, and the
    N-th ``step_end`` stops it — one profile per instance, covering exactly
    ``n_steps`` engine steps (admission, chunk and decode dispatch
    included).  The profiler traces the CPU and, with ``cuda=True``, the
    card (the settings under which the card's records of kernels inside
    CUDA-graph replays are seen); on stop the card is synchronised and the
    Chrome/Perfetto trace is written to ``logdir`` as
    ``steps_<first>-<end>.pt.trace.json`` (its path on ``.path``).
    ``start(logdir)``/``stop()`` are injectable for tests."""

    def __init__(self, logdir: str, n_steps: int,
                 trace: Optional[EventTrace] = None,
                 start: Optional[Callable[[str], Any]] = None,
                 stop: Optional[Callable[[], Any]] = None,
                 cuda: bool = False):
        if n_steps < 1:
            raise ValueError(f"n_steps={n_steps} must be >= 1")
        self.logdir = logdir
        self.n_steps = n_steps
        self.remaining = n_steps
        self.active = False
        self.done = False
        self.cuda = cuda
        self.path: Optional[str] = None
        self._trace = trace
        self._start = start
        self._stop = stop
        self._prof = None
        self._steps = (0, 0)

    def _torch_start(self, logdir: str) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def _torch_stop(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(
            self.logdir, f"steps_{self._steps[0]}-{self._steps[1]}"
                         ".pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    def step_start(self, step: int = 0) -> None:
        if self.done or self.active:
            return
        if self._start is None:
            self._start = self._torch_start
            self._stop = self._stop or self._torch_stop
        self._steps = (step, step)
        self._start(self.logdir)
        self.active = True
        if self._trace is not None:
            self._trace.emit("profile_start", step=step,
                             logdir=self.logdir, n_steps=self.n_steps)

    def step_end(self, step: int = 0) -> None:
        if not self.active:
            return
        self.remaining -= 1
        if self.remaining > 0:
            return
        self._steps = (self._steps[0], step)
        self._stop()
        self.active = False
        self.done = True
        if self._trace is not None:
            self._trace.emit("profile_stop", step=step, logdir=self.logdir)
