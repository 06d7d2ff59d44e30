"""Serving launcher of the port (lockstep batch): init seeded weights,
calibrate and absorb SWAN, run batched generation.

    python -m repro_torch.launch.serve --arch llama3-8b --swan \
        --k 64 --buffer 128 --prompt-len 2048 --tokens 64 --max-seq 4096

runs on the card; ``--smoke --device cpu`` runs the small configuration
through the plain PyTorch path on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import SwanConfig, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import KERNELS
from repro_torch.kernels.build import build_all
from repro_torch.launch.io import make_batch
from repro_torch.models.registry import get_model, swan_applicable
from repro_torch.runtime.serve_loop import ServeSession, calibrate_swan


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--swan", action="store_true")
    ap.add_argument("--k", type=int, default=None)
    ap.add_argument("--buffer", type=int, default=128)
    ap.add_argument("--mode", default="topk", choices=["topk", "truncate"])
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":   # build before anything is timed
        t0 = time.perf_counter()
        build_all(KERNELS)
        print(f"kernels built in {time.perf_counter() - t0:.1f}s")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = get_model(cfg)
    params = api.init_params(cfg, 0, device)

    swan = projections = None
    if args.swan:
        if not swan_applicable(cfg):
            raise SystemExit(f"SWAN inapplicable to {cfg.name}")
        b = min(args.buffer, args.max_seq // 4)
        swan = SwanConfig(k_max=args.k or cfg.d_head // 2, buffer=b,
                          mode=args.mode, quantize=args.quantize)
        projections = calibrate_swan(api, cfg, params,
                                     make_batch(cfg, 4, 64, seed=3,
                                                device=device))
        params = api.absorb(params, cfg, projections)
        print(f"SWAN: k_max={swan.k_max}/{cfg.d_head} buffer={b} "
              f"mode={swan.mode} int8={swan.quantize}")

    sess = ServeSession(cfg, params, swan=swan, projections=projections,
                        max_seq=args.max_seq, batch=args.batch, device=device)
    prompt = make_batch(cfg, args.batch, args.prompt_len, seed=11,
                        device=device)
    _sync(device)
    t0 = time.perf_counter()
    out = sess.generate(prompt, args.tokens, temperature=args.temperature)
    _sync(device)
    dt = time.perf_counter() - t0
    for i in range(min(args.batch, 2)):
        print(f"seq {i}: {out[i].tolist()}")
    n_tok = out.numel()
    print(f"generated {n_tok} tokens in {dt:.3f}s ({n_tok / dt:.1f} tok/s, "
          f"prefill included) on {device}")
    rep = sess.cache_report()
    extra = f" ({rep['saving']:.0%} vs dense)" if "saving" in rep else ""
    print(f"cache [{rep['mode']}]: {rep['bytes'] / 1e6:.2f} MB{extra}")


if __name__ == "__main__":
    main()
