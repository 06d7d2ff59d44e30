"""Paper Fig. 4 (structural reproduction): long-context error propagation.

Without task suites offline, we measure how SWAN's compression error
accumulates with decode length: top-1 agreement and logit error vs the
dense baseline at increasing positions, buffered vs zero-buffer (on the
card the bt8 decode reads go through the decode kernel).

Paper shape: bt>0 stays close to baseline far into the sequence; bt=0
drifts rapidly.

    python -m repro_torch.benchmarks.bench_longcontext_error [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.benchmarks.common import (bench_record, emit, eval_tokens,
                                           trained_tiny_lm)
from repro_torch.configs import SwanConfig
from repro_torch.device import DeviceLike, f32_matmul, resolve_device
from repro_torch.models.registry import get_model

CHECKPOINTS = [32, 64, 128, 224]


@torch.no_grad()
def _drift(cfg, params_d, params_s, pj, swan, tokens):
    """{position: (top-1 agreement so far, max |logit error| there)} of the
    SWAN session against the dense one, both teacher-forced on ``tokens``
    from an 8-token prompt.  One host read, at the end."""
    api = get_model(cfg)
    B, S = tokens.shape
    with f32_matmul():
        st_d = api.init_serve_state(cfg, None, B, S + 1, tokens.device)
        st_s = api.init_serve_state(cfg, swan, B, S + 1, tokens.device)
        prompt = {"tokens": tokens[:, :8]}
        lg_d, st_d = api.prefill(params_d, cfg, prompt, st_d)
        lg_s, st_s = api.prefill(params_s, cfg, prompt, st_s, swan, pj)
        lg_d, lg_s = lg_d[:, -1], lg_s[:, -1]
        agree, at = [], {}
        for t in range(8, S):
            agree.append((lg_d.argmax(-1) == lg_s.argmax(-1)).float().mean())
            if t in CHECKPOINTS:
                at[t] = (len(agree), (lg_d - lg_s).abs().max())
            tok = tokens[:, t]
            lg_d, st_d = api.decode_step(params_d, cfg, tok, t, st_d)
            lg_s, st_s = api.decode_step(params_s, cfg, tok, t, st_s, swan, pj)
    # running means in f64, as the reference sums its per-step host floats
    csum = torch.stack(agree).double().cumsum(0).tolist()
    return {t: (csum[n - 1] / n, float(err)) for t, (n, err) in at.items()}


def _run(dev) -> None:
    cfg, params, pj, absorbed = trained_tiny_lm(dev)
    tokens = eval_tokens(cfg, seq=228, device=dev)
    k = cfg.d_head // 8   # deep-compression regime where drift is visible
    for name, swan in [("bt8", SwanConfig(k_max=k, buffer=8, mode="topk")),
                       ("bt0", SwanConfig(k_max=k, buffer=0, mode="topk"))]:
        t0 = time.perf_counter()
        drift = _drift(cfg, params, absorbed, pj, swan, tokens)
        us = (time.perf_counter() - t0) * 1e6 / max(len(drift), 1)
        for t, (agree, err) in sorted(drift.items()):
            emit("fig4_longcontext_drift", us,
                 f"{name}_pos={t}_top1agree={agree:.3f}_logit_err={err:.3f}")


def run(device: DeviceLike = None):
    dev = resolve_device(device)
    with bench_record("longcontext_error_torch", dev) as rec:
        _run(dev)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(ap.parse_args().device)
