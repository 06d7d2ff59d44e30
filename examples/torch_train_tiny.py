"""Train a small LM end to end with the PyTorch/CUDA port, checkpoint,
resume after a simulated preemption, then calibrate SWAN on the trained
weights and score it through the compressed serving path.

    PYTHONPATH=src python examples/torch_train_tiny.py [--steps 200] \
        [--device cpu]

The counterpart of ``examples/train_tiny.py``: data pipeline -> train
loop (grad clip, schedule, async checkpoints, straggler watchdog) ->
resume from the checkpoint -> SWAN calibration -> NLL readout.  Runs on
the card unless ``--device cpu`` is given.
"""
import argparse
import os
import shutil
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch.benchmarks.common import (eval_tokens,  # noqa: E402
                                           swan_teacher_forced_nll,
                                           tiny_lm_config)
from repro_torch.configs import (OptimizerConfig, SwanConfig,  # noqa: E402
                                 TrainConfig)
from repro_torch.device import f32_matmul  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.runtime.serve_loop import calibrate_swan  # noqa: E402
from repro_torch.runtime.train_loop import Trainer  # noqa: E402


def train(tc, device, steps=None):
    """One ``Trainer.run`` whose SIGTERM handler is removed afterwards."""
    trainer = Trainer(tc, device=device)
    try:
        return trainer.run(steps=steps)
    finally:
        trainer.preemption.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_tiny"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    shutil.rmtree(args.ckpt, ignore_errors=True)

    cfg = tiny_lm_config()
    tc = TrainConfig(model=cfg, seq_len=64, global_batch=16, steps=args.steps,
                     optimizer=OptimizerConfig(lr=6e-3, warmup_steps=20,
                                               decay_steps=args.steps),
                     checkpoint_dir=args.ckpt,
                     checkpoint_every=args.steps // 2, log_every=20)

    with f32_matmul():
        # train the first half, "crash", then resume (restart semantics)
        out = train(tc, args.device, args.steps // 2)
        print(f"-- simulated preemption at step {out['step']}; resuming --")
        out = train(tc, args.device)
    for row in out["log"][:2] + out["log"][-2:]:
        print(f"  step {row['step']:4d}  loss {row['loss']:.3f}  "
              f"lr {row['lr']:.2e}")
    if out["stragglers"]:
        print(f"  watchdog flagged {len(out['stragglers'])} straggler steps")

    # SWAN on the trained model
    params = out["params"]
    api = get_model(cfg)
    with f32_matmul():
        calib = {"tokens": eval_tokens(cfg, batch=8, seq=96, step=50_000,
                                       device=args.device)}
        pj = calibrate_swan(api, cfg, params, calib)
        absorbed = api.absorb(params, cfg, pj)
    tokens = eval_tokens(cfg, seq=128, device=args.device)
    base = swan_teacher_forced_nll(cfg, params, tokens, None)
    print(f"\n{'setting':>24} | eval NLL")
    print(f"{'dense baseline':>24} | {base:.4f}")
    for ratio in (0.75, 0.5):
        k = int(cfg.d_head * ratio)
        swan = SwanConfig(k_max=k, buffer=16, mode="topk")
        nll = swan_teacher_forced_nll(cfg, absorbed, tokens, swan, pj)
        print(f"{f'swan k={k}/{cfg.d_head} bt=16':>24} | {nll:.4f}")


if __name__ == "__main__":
    main()
