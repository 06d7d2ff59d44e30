"""Training launcher of the port.

    python -m repro_torch.launch.train --arch llama3-8b --smoke \
        --steps 50 --batch 8 --seq 128 --device cpu [--data tokens.bin]

trains the small configuration on the CPU; without ``--device cpu`` the
run is on the card.  ``--arch`` is llama3-8b, yi-9b, olmo-1b (whose
tied embedding takes the gradients of both its uses), deepseek-moe-16b
or qwen2-moe-a2.7b (whose loss adds the experts' load-balance and router
z-losses) or internvl2-1b (trained, as by the reference's trainer, on
token batches without patch embeddings), jamba-1.5-large-398b (Mamba,
attention and MoE layers; its loss adds the experts' aux losses) or
rwkv6-3b, or llama3-405b; without ``--smoke`` each is its full
configuration, which for all but olmo-1b and internvl2-1b needs more
memory than one card holds.  The AdamW moments take the config's
``opt_state_dtype`` (bfloat16 for jamba-1.5-large-398b and llama3-405b,
float32 elsewhere), as in the reference's launcher.  whisper-small is
refused: the token stream carries no encoder frames (the reference's
trainer fails on it with ``KeyError: 'frames'``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import (OptimizerConfig, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.data.pipeline import FileStream
from repro_torch.runtime.train_loop import Trainer


def main(argv=None):
    """Parse ``argv`` and train; returns ``Trainer.run``'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--data", help="binary token file (default: synthetic)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_decoder:
        raise SystemExit(f"{cfg.name}: the training stream holds tokens "
                         "only, and an encoder-decoder needs encoder frames")
    if args.grad_accum:
        cfg = cfg.replace(grad_accum=args.grad_accum)
    tc = TrainConfig(
        model=cfg, seq_len=args.seq, global_batch=args.batch,
        steps=args.steps,
        optimizer=OptimizerConfig(lr=args.lr, decay_steps=args.steps,
                                  state_dtype=cfg.opt_state_dtype),
        checkpoint_dir=args.ckpt_dir, checkpoint_every=args.ckpt_every,
        log_every=max(args.steps // 20, 1),
        grad_compression=args.grad_compression)
    stream = None
    if args.data:
        stream = FileStream(args.data, cfg.vocab_size, args.batch, args.seq)
    trainer = Trainer(tc, stream=stream, device=args.device)
    try:
        out = trainer.run()
    finally:
        trainer.preemption.close()
    for row in out["log"]:
        print(f"step {row['step']:6d}  loss {row['loss']:.4f}  "
              f"gnorm {row['grad_norm']:.3f}  lr {row['lr']:.2e}")
    if out["stragglers"]:
        print(f"watchdog: {len(out['stragglers'])} straggler steps flagged")
    print(f"finished at step {out['step']}; checkpoints in {args.ckpt_dir}")
    return out


if __name__ == "__main__":
    main()
