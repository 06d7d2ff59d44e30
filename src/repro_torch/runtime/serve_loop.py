"""Lockstep serving: SWAN calibration and a batched generation session.

Port of ``repro.runtime.serve_loop``.  The session's
caches live on its device and prefill/decode update them in place.  On the
card every layer's SWAN decode read goes through the CUDA kernel
(``repro_torch.kernels.swan_decode``), and with ``graphs`` (on by default
there) each decode step is one CUDA-graph replay, with the token and
``pos`` as static device operands, and each prompt shape's prefill one
graph, as ``jax.jit`` compiles the reference's per shape
(``runtime.graphs``).  ``metrics`` counts prefill and decode calls and
times each call on the host (the enqueue, or a capture at first use; no
device sync), as the reference times its jitted calls.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import projections as proj_mod
from repro_torch.core.analytical import model_cache_footprint
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import get_model, swan_applicable
from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from repro_torch.runtime.graphs import GraphSet
from repro_torch.runtime.sampling import sample_token

# wall-clock step-call buckets (ms), the reference's: they time the host
# call around a step, so a capture at first use shows in the top buckets
STEP_MS_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
                   128.0, 256.0, 512.0, 1024.0)

Params = Dict[str, Any]


def calibrate_swan(api, cfg, params, calib_batch) -> Params:
    """Offline calibration (§4.1): capture activations, joint SVD."""
    q, k, v, wo = api.collect_qkv(params, cfg, calib_batch)
    return proj_mod.compute_projections((q, k, v), wo, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.d_head)


class _DenseLike:
    def __init__(self, d_head):
        self.k_max = d_head
        self.buffer = 0
        self.quantize = False


def serve_cache_report(cfg, swan, batch: int, max_seq: int) -> Dict[str, Any]:
    """Physical cache accounting (paper Eq. 1); ``swan`` None -> dense."""
    if swan is None:
        fp = model_cache_footprint(cfg, _DenseLike(cfg.d_head), batch, max_seq)
        return {"mode": "dense", "bytes": fp.dense_bytes}
    fp = model_cache_footprint(cfg, swan, batch, max_seq)
    return {"mode": f"swan[{swan.mode}]", "bytes": fp.swan_bytes,
            "dense_bytes": fp.dense_bytes, "saving": fp.saving}


class ServeSession:
    """Batched autoregressive generation with an optional SWAN cache.

    ``device`` None means the card: constructing a session without a card
    and without ``device="cpu"`` raises.  ``params`` must already live on
    that device.  ``graphs`` (None: on for a CUDA device) replays prefill
    and decode as CUDA graphs; ``graphs=True`` without a card raises.
    ``metrics``: False (the default, the no-op registry), True (a fresh
    registry) or a registry to share."""

    def __init__(self, cfg, params, swan=None, projections=None,
                 max_seq: int = 4096, batch: int = 1,
                 graphs: Optional[bool] = None, device: DeviceLike = None,
                 metrics=False):
        if isinstance(metrics, MetricsRegistry):
            self.metrics = metrics
        else:
            self.metrics = MetricsRegistry() if metrics else NULL_REGISTRY
        self.device = resolve_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        self._graphs = GraphSet(self.device) if graphs else None
        self.cfg = cfg
        self.api = get_model(cfg)
        self.swan = (swan if (swan and swan.enabled and swan_applicable(cfg))
                     else None)
        self.projections = projections
        self.max_seq = max_seq
        self.batch = batch
        if self.swan is not None:
            self.swan.validate(cfg.d_head)
            if projections is None:
                raise ValueError("SWAN enabled but no projections given — "
                                 "run calibrate_swan first")
        self.params = params
        self.state = self.api.init_serve_state(cfg, self.swan, batch, max_seq,
                                               self.device)
        self.pos = 0

    def prefill(self, batch_in: Params) -> torch.Tensor:
        """Prefill ``batch_in``: its tokens, and a VLM's ``prefix_embeds``
        or an encoder-decoder's ``frames`` where it holds them.  The next
        decode position is the prefill's full length: a VLM's patch
        positions and its tokens.  (The reference's session continues at
        the token count, inside the patch prefix; the port does not keep
        that fault.)"""
        t0 = time.perf_counter()
        names = [n for n in ("tokens", "prefix_embeds", "frames")
                 if batch_in.get(n) is not None]
        ops = [batch_in[n] for n in names]
        n_prefix = (0 if batch_in.get("prefix_embeds") is None
                    else batch_in["prefix_embeds"].shape[1])
        length = batch_in["tokens"].shape[1] + n_prefix
        if length > self.max_seq:
            raise ValueError(f"prompt of {length} positions exceeds "
                             f"max_seq={self.max_seq}")

        def fn(*ops):
            logits, _ = self.api.prefill(self.params, self.cfg,
                                         dict(zip(names, ops)), self.state,
                                         self.swan, self.projections)
            return logits[:, -1]
        if self._graphs is None:
            logits = fn(*ops)
        else:
            # the capture's zero operands write the rows the real ones
            # rewrite
            logits = self._graphs.run(
                "prefill", tuple(tuple(x.shape) for x in ops), fn, ops,
                lambda: [torch.zeros_like(x) for x in ops]).clone()
        self.metrics.counter("session_prefill_total", "prefill calls").inc()
        self.metrics.histogram(
            "session_prefill_call_ms", STEP_MS_BUCKETS,
            "host wall-clock of the prefill call (captures show as "
            "outliers)").observe((time.perf_counter() - t0) * 1e3)
        self.pos = length
        return logits

    def decode(self, token: torch.Tensor) -> torch.Tensor:
        if self.pos >= self.max_seq:
            raise ValueError(f"position {self.pos} is past max_seq="
                             f"{self.max_seq}")
        t0 = time.perf_counter()
        if self._graphs is None:
            logits, self.state = self.api.decode_step(
                self.params, self.cfg, token, self.pos, self.state, self.swan,
                self.projections)
        else:
            def fn(tok, pos):
                logits, _ = self.api.decode_step(
                    self.params, self.cfg, tok, pos, self.state, self.swan,
                    self.projections)
                return logits
            B = token.shape[0]
            # dead operands: every lane at pos = -1 changes nothing
            logits = self._graphs.run(
                "decode", B, fn, [token, np.full((B,), self.pos, np.int32)],
                lambda: [torch.zeros_like(token),
                         np.full((B,), -1, np.int32)]).clone()
        self.metrics.counter("session_decode_total",
                             "decode step calls").inc()
        self.metrics.histogram(
            "session_decode_call_ms", STEP_MS_BUCKETS,
            "host wall-clock of the decode call (captures show as "
            "outliers)").observe((time.perf_counter() - t0) * 1e3)
        self.pos += 1
        return logits

    def generate(self, batch_in: Params, n_tokens: int,
                 temperature: float = 0.0, seed: int = 0) -> torch.Tensor:
        """Greedy (or sampled) generation; returns [B, n_tokens] int64."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits = self.prefill(batch_in)
        tok = sample_token(logits, temperature, gen)
        tok_ctr = self.metrics.counter("session_tokens_generated_total",
                                       "tokens sampled by generate()")
        outs = []
        for i in range(n_tokens):
            outs.append(tok)
            tok_ctr.inc(self.batch)
            if i == n_tokens - 1:
                break
            logits = self.decode(tok)
            tok = sample_token(logits, temperature, gen)
        return torch.stack(outs, dim=1)

    def cache_report(self) -> Dict[str, Any]:
        """Physical cache accounting (paper Eq. 1 applied to this model)."""
        return serve_cache_report(self.cfg, self.swan, self.batch,
                                  self.max_seq)
