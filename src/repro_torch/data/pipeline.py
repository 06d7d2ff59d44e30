"""Deterministic data pipeline: synthetic token streams + binary token files.

The port's own copy of ``repro.data.pipeline`` (numpy only): for one
(seed, step, host) both packages yield the same batch bit for bit.

* ``SyntheticStream`` — hash-based deterministic tokens with local structure
  (Markov-ish mixing) so that tiny LMs can actually learn something; fully
  reproducible given (seed, step), which makes checkpoint-resume bit-exact
  without saving data state.
* ``FileStream`` — memory-mapped binary token shards with per-host disjoint
  striding, epoch reshuffling, background prefetch thread.

Both yield {"tokens": [B, S+1]} host arrays; the train step slices
inputs/targets.  Per-host sharding: host h of H reads rows where
(row % H == h) — disjoint by construction (test-enforced).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticStream:
    """Deterministic synthetic LM data.

    Sequences mix three mechanisms (probabilities ``markov/copy/noise``):
      * a vocabulary-walk with a fixed stochastic matrix seeded from
        ``seed`` (local structure — learnable from the previous token),
      * a *long-range copy*: token[t] = token[t - copy_period] — only
        learnable by attending ``copy_period`` back (induction-head style),
        which is what makes KV-cache compression quality measurable: the
        copied-from tokens live OUTSIDE a small recency buffer,
      * uniform noise.
    Fully reproducible given (seed, step): checkpoint resume is bit-exact
    without data-state snapshots.
    """

    def __init__(self, vocab_size: int, batch: int, seq: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1,
                 markov: float = 0.45, copy: float = 0.45,
                 copy_period: int = 24):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.markov = markov
        self.copy = copy
        self.copy_period = copy_period
        base = np.random.default_rng(seed)
        self._next_tok = base.integers(0, vocab_size, size=vocab_size)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.n_hosts + self.host_id)
        B, S, V = self.batch, self.seq + 1, self.vocab
        P = self.copy_period
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        u = rng.random((B, S))
        rand = rng.integers(0, V, (B, S))
        for t in range(1, S):
            out = np.where(u[:, t] < self.markov,
                           self._next_tok[toks[:, t - 1]], rand[:, t])
            if t >= P:
                use_copy = (u[:, t] >= self.markov) & \
                    (u[:, t] < self.markov + self.copy)
                out = np.where(use_copy, toks[:, t - P], out)
            toks[:, t] = out
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class FileStream:
    """Binary uint16/uint32 token shards, memory-mapped, host-striped."""

    def __init__(self, path: str, vocab_size: int, batch: int, seq: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1,
                 dtype=np.uint16, prefetch: int = 2):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab_size
        self.batch, self.seq = batch, seq
        self.seed, self.host_id, self.n_hosts = seed, host_id, n_hosts
        self.n_rows = len(self.tokens) // (seq + 1)
        if self.n_rows < batch:
            raise ValueError(f"file {path} too small: {self.n_rows} rows")
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        epoch = step * self.batch * self.n_hosts // self.n_rows
        rng = np.random.default_rng(self.seed + epoch)
        perm = rng.permutation(self.n_rows)
        base = (step * self.batch * self.n_hosts) % self.n_rows
        rows = perm[(base + self.host_id * self.batch +
                     np.arange(self.batch)) % self.n_rows]
        S = self.seq + 1
        out = np.stack([self.tokens[r * S:(r + 1) * S] for r in rows])
        return {"tokens": np.minimum(out.astype(np.int32), self.vocab - 1)}

    def _worker(self, start_step: int):
        step = start_step
        while True:
            self._q.put(self.batch_at(step))
            step += 1

    def prefetching_iter(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        self._thread = threading.Thread(target=self._worker,
                                        args=(start_step,), daemon=True)
        self._thread.start()
        while True:
            yield self._q.get()


def write_token_file(path: str, tokens: np.ndarray, dtype=np.uint16) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.asarray(tokens, dtype).tofile(path)
