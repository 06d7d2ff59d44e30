"""Fault-tolerance utilities: preemption handling + straggler watchdog.

The port's own copy of ``repro.runtime.fault_tolerance`` (no JAX in it).

* ``PreemptionHandler`` — installs a SIGTERM handler (the preemption signal
  of a cluster scheduler); the training loop checkpoints and exits cleanly when
  triggered.  Idempotent install, restores previous handler on close.
* ``StepWatchdog`` — EMA-based step-time anomaly detector.  On a real
  cluster a straggling host shows up as a slow *global* step (collectives
  synchronise); the watchdog flags steps slower than ``threshold×`` the EMA
  so the operator (or an external policy) can checkpoint-and-requeue.
"""
from __future__ import annotations

import signal
import threading
from typing import List, Optional, Tuple


class PreemptionHandler:
    def __init__(self, sig=signal.SIGTERM):
        self._triggered = threading.Event()
        self._sig = sig
        self._prev = None
        try:
            self._prev = signal.signal(sig, self._handle)
            self.installed = True
        except ValueError:        # non-main thread (tests)
            self.installed = False

    def _handle(self, signum, frame):
        self._triggered.set()

    @property
    def triggered(self) -> bool:
        return self._triggered.is_set()

    def trigger(self) -> None:    # for tests / manual drain
        self._triggered.set()

    def close(self) -> None:
        if self.installed and self._prev is not None:
            signal.signal(self._sig, self._prev)


class StepWatchdog:
    """Flags straggler steps: duration > threshold × EMA(duration)."""

    def __init__(self, threshold: float = 3.0, ema_decay: float = 0.9,
                 warmup_steps: int = 3):
        self.threshold = threshold
        self.decay = ema_decay
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.n = 0
        self.stragglers: List[Tuple[int, float, float]] = []  # (step, dt, ema)

    def record(self, step: int, duration: float) -> bool:
        self.n += 1
        if self.ema is None:
            self.ema = duration
            return False
        is_straggler = (self.n > self.warmup and
                        duration > self.threshold * self.ema)
        if is_straggler:
            self.stragglers.append((step, duration, self.ema))
        else:
            # stragglers don't poison the EMA
            self.ema = self.decay * self.ema + (1 - self.decay) * duration
        return is_straggler
