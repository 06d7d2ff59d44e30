"""Shared benchmark infrastructure (port of ``benchmarks/common.py``).

* ``trained_tiny_lm()`` — trains (once per process, and once on disk) the
  reference's small llama-family LM on the deterministic synthetic corpus
  on the given device; the quality benchmarks (paper Tables 1-3, Figs
  2b/3/4, adaptive k) score this model under different SWAN settings.
  ``$REPRO_BENCH_STEPS`` (default 900) sets its training steps and
  ``$REPRO_BENCH_CKPT`` (default ``repro_torch_bench_lm`` in the temporary
  directory) its checkpoint directory: a checkpoint there at or past the
  step count is restored instead of training again, also one written by
  the reference's trainer.
* ``swan_teacher_forced_nll`` — SWAN-faithful perplexity: tokens are
  scored through the serving path (prefill + incremental decode with the
  compressed hybrid cache; on the card the decode kernel reads it), so
  compression errors propagate exactly as in deployment.
* ``timeit_call`` — microbenchmark helper returning us per call.  A call
  whose result lies on the card is timed with CUDA events: the median
  over the launches, the L2 cache flushed before each one (``time_ms``);
  a CPU result with ``perf_counter``.
* ``serve_model`` — the serve benches' model: the reference benches' tiny
  float32 llama3-8b variant, or llama3-8b at full width in bf16.
* ``bench_record`` / ``BenchRecorder`` — machine-readable run artifacts:
  a benchmark writes ``BENCH_<name>.json`` (CSV rows, gate results,
  optional ``repro_torch.obs`` metrics snapshots, torch version, and the
  card's name or ``cpu``) into ``$REPRO_BENCH_OUT`` (default
  ``bench_out/``).
"""
from __future__ import annotations

import functools
import json
import os
import statistics
import sys
import tempfile
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs import (ModelConfig, OptimizerConfig, SwanConfig,
                                 TrainConfig)
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.device import DeviceLike, f32_matmul, resolve_device

L2_FLUSH_BYTES = 256 << 20       # > the H100's 50 MB L2: each launch starts cold


def serve_model(smoke: bool, device: torch.device, calib_len: int = 32,
                dtype: Optional[str] = None):
    """The serve benches' model on ``device``, from seeded weights with
    SWAN calibrated and absorbed: with ``smoke`` the reference benches'
    own float32 llama3-8b variant (2 layers, d_model 64), else llama3-8b
    at full width in bf16, or in ``dtype`` (params and activations) when
    given.  On the card the kernel libraries are built first, so that no
    timed call pays ``nvcc``.  Returns (cfg, params, projections,
    absorbed)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.build import build_all
    from repro_torch.launch.io import make_batch
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.serve_loop import calibrate_swan
    if device.type == "cuda":
        build_all(KERNELS)
    cfg = (get_smoke_config("llama3-8b").replace(
        dtype="float32", param_dtype="float32") if smoke
        else get_config("llama3-8b"))
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype, param_dtype=dtype)
    api = get_model(cfg)
    params = api.init_params(cfg, 0, device)
    pj = calibrate_swan(api, cfg, params,
                        make_batch(cfg, 2, calib_len, seed=3, device=device))
    return cfg, params, pj, api.absorb(params, cfg, pj)


# ---------------------------------------------------------------------------
# The quality benchmarks' trained model and scoring
# ---------------------------------------------------------------------------

def tiny_lm_config() -> ModelConfig:
    return ModelConfig(
        name="bench-tiny-lm", family="dense",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=384, vocab_size=512, act="silu", rope_theta=10000.0,
        dtype="float32", param_dtype="float32", remat=False,
    )


def _bench_env():
    return (os.environ.get("REPRO_BENCH_CKPT",
                           os.path.join(tempfile.gettempdir(),
                                        "repro_torch_bench_lm")),
            int(os.environ.get("REPRO_BENCH_STEPS", "900")))


@functools.lru_cache(maxsize=1)
def _trained(device: torch.device, ckpt_dir: str, steps: int):
    from repro_torch.models.registry import get_model
    from repro_torch.runtime.serve_loop import calibrate_swan
    from repro_torch.runtime.train_loop import Trainer
    cfg = tiny_lm_config()
    tc = TrainConfig(
        model=cfg, seq_len=64, global_batch=16, steps=steps,
        optimizer=OptimizerConfig(lr=6e-3, warmup_steps=20,
                                  decay_steps=steps),
        checkpoint_dir=ckpt_dir, checkpoint_every=steps,
        log_every=max(steps // 5, 1), seed=0)
    trainer = Trainer(tc, device=device)
    latest = trainer.ckpt.latest_step()
    with f32_matmul():
        try:
            if latest is not None and latest >= steps:
                params, _, _ = trainer.restore_or_init()
                log = None
            else:
                out = trainer.run()
                if out["step"] != steps:
                    raise RuntimeError(
                        f"tiny-lm training stopped at step {out['step']} of "
                        f"{steps} (preempted); its checkpoint resumes it")
                params, log = out["params"], out["log"]
        finally:
            trainer.preemption.close()
        api = get_model(cfg)
        # calibration data: the training language (same seed) at an unseen
        # step, the paper's held-out calibration set
        calib = SyntheticStream(cfg.vocab_size, 8, 96,
                                seed=0).batch_at(50_000)["tokens"][:, :96]
        pj = calibrate_swan(api, cfg, params,
                            {"tokens": torch.as_tensor(calib, device=device)})
        absorbed = api.absorb(params, cfg, pj)
    if log:
        print(f"# tiny-lm trained: loss {log[0]['loss']:.3f} -> "
              f"{log[-1]['loss']:.3f} over {steps} steps")
    return cfg, params, pj, absorbed, log


def trained_tiny_lm(device: DeviceLike = None, with_log: bool = False):
    """Returns (cfg, params, projections, absorbed_params) on ``device``
    (the card by default), and the training log (None when restored) as a
    fifth element with ``with_log``."""
    out = _trained(resolve_device(device), *_bench_env())
    return out if with_log else out[:4]


def eval_tokens(cfg, batch: int = 8, seq: int = 160, step: int = 100_000,
                device: DeviceLike = None) -> torch.Tensor:
    """Held-out batch from the TRAINING language (same seed, unseen step)."""
    s = SyntheticStream(cfg.vocab_size, batch, seq, seed=0)
    return torch.as_tensor(s.batch_at(step)["tokens"][:, :seq],
                           device=resolve_device(device))


@torch.no_grad()
def swan_teacher_forced_nll(cfg, params, tokens: torch.Tensor,
                            swan: Optional[SwanConfig], projections=None,
                            prompt_len: int = 8) -> float:
    """Mean NLL of tokens[prompt_len:] scored through the serving path, on
    ``tokens``' device (in full f32 matrix products there: TF32 would move
    the tiny LM's NLLs by about 1e-3).  One host read, at the end."""
    from repro_torch.models.registry import get_model
    api = get_model(cfg)
    B, S = tokens.shape
    with f32_matmul():
        state = api.init_serve_state(cfg, swan, B, S + 1, tokens.device)
        logits, state = api.prefill(params, cfg,
                                    {"tokens": tokens[:, :prompt_len]},
                                    state, swan, projections)
        logits = logits[:, -1]
        nll = []
        for t in range(prompt_len, S):
            target = tokens[:, t]
            lp = torch.log_softmax(logits.float(), dim=-1)
            nll.append(-lp.gather(1, target[:, None].long()).mean())
            if t < S - 1:
                logits, state = api.decode_step(params, cfg, target, t, state,
                                                swan, projections)
    # summed in f64, as the reference sums its per-step host floats
    return float(torch.stack(nll).double().sum()) / len(nll)


def time_ms(fn: Callable[[], Any], reps: int,
            flush: Optional[torch.Tensor] = None) -> float:
    """Median device time in ms of ``fn`` over ``reps`` launches (CUDA
    events), with the L2 cache flushed before each launch when ``flush``
    (a device buffer larger than L2) is given."""
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _on_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(o) for o in out)
    return False


def timeit_call(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """us per call of ``fn(*args)``: on the card the median of ``iters``
    CUDA-event timings with L2 flushed, on the CPU the mean wall time."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if _on_cuda(out):
        torch.cuda.synchronize()
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                            device=torch.cuda.current_device())
        return time_ms(lambda: fn(*args), iters, flush) * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6


def emit(name: str, us_per_call: float, derived: str) -> None:
    """CSV row in the ``name,us_per_call,derived`` format.  Also recorded
    into the active :class:`BenchRecorder`, if any."""
    print(f"{name},{us_per_call:.1f},{derived}")
    if _ACTIVE is not None:
        _ACTIVE.rows.append({"name": name,
                             "us_per_call": float(us_per_call),
                             "derived": derived})


# ---------------------------------------------------------------------------
# Machine-readable benchmark artifacts
# ---------------------------------------------------------------------------

_ACTIVE: Optional["BenchRecorder"] = None


class BenchRecorder:
    """Collects one benchmark's CSV rows, gate verdicts and metrics
    snapshots for the ``BENCH_<name>.json`` artifact."""

    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.device = device
        self.rows: List[Dict[str, Any]] = []
        self.gates: List[Dict[str, Any]] = []
        self.extra: Dict[str, Any] = {}

    def gate(self, name: str, passed: bool, detail: str = "") -> None:
        """Record a pass/fail gate, THEN assert it: a failing gate still
        lands in the JSON artifact (written in ``bench_record``'s finally
        block)."""
        self.gates.append({"name": name, "passed": bool(passed),
                           "detail": detail})
        assert passed, f"gate {name}: {detail}"

    def add_metrics(self, registry, tag: str = "engine") -> None:
        """Attach a ``repro_torch.obs`` MetricsRegistry snapshot under
        ``tag``."""
        self.extra.setdefault("metrics", {})[tag] = registry.snapshot()

    def payload(self, ok: bool) -> Dict[str, Any]:
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu")
        return {"bench": self.name, "ok": ok,
                "torch_version": torch.__version__, "device": dev,
                "rows": self.rows, "gates": self.gates, "extra": self.extra}


def bench_out_dir() -> str:
    return os.environ.get("REPRO_BENCH_OUT", "bench_out")


def gate(name: str, passed: bool, detail: str = "") -> None:
    """Module-level gate: records into the active recorder when one is
    open (so the artifact keeps the verdict), always asserts."""
    if _ACTIVE is not None:
        _ACTIVE.gate(name, passed, detail)
    else:
        assert passed, f"gate {name}: {detail}"


def record_metrics(registry, tag: str = "engine") -> None:
    """Attach a metrics snapshot to the active recorder (no-op outside
    ``bench_record``)."""
    if _ACTIVE is not None:
        _ACTIVE.add_metrics(registry, tag)


@contextmanager
def bench_record(name: str, device: torch.device):
    """Scope one benchmark run on ``device``: ``emit``/``gate`` calls
    inside are captured, and ``BENCH_<name>.json`` (which names the device)
    is written on exit — also when a gate fails, with ``ok: false`` and the
    failing verdict included."""
    global _ACTIVE
    rec = BenchRecorder(name, device)
    prev, _ACTIVE = _ACTIVE, rec
    ok = False
    try:
        yield rec
        ok = True
    finally:
        _ACTIVE = prev
        outdir = bench_out_dir()
        try:
            os.makedirs(outdir, exist_ok=True)
            path = os.path.join(outdir, f"BENCH_{name}.json")
            with open(path, "w") as fh:
                json.dump(rec.payload(ok), fh, indent=2, sort_keys=True)
        except OSError as e:                      # never mask the gate error
            print(f"# bench_record({name}): artifact write failed: {e}",
                  file=sys.stderr)
