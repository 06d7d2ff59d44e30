"""Long-context decode with runtime-tunable compression, on the PyTorch/CUDA
port.

    PYTHONPATH=src python examples/torch_long_context_decode.py \
        [--arch llama3-8b] [--smoke] [--device cpu]

The counterpart of ``examples/long_context_decode.py``, on the card by
default: the SAME deployed weights serve at several compression levels
(the runtime knobs k_key/k_value <= k_max change per session with no
offline step), and decoding past a long prompt shows how far each level's
logits move from the dense cache's.  ``--smoke`` takes the reference
example's small float32 model (llama3-8b) or the arch's smoke
configuration in float32, with its 384-token prompt; without it the full
published configuration runs in bf16 over a 3072-token prompt.
"""
import argparse
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import (ARCH_IDS, SwanConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.core.analytical import model_cache_footprint  # noqa: E402
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.runtime.serve_loop import (ServeSession,  # noqa: E402
                                            calibrate_swan)


def model_config(arch, smoke):
    """The reference example's model for llama3-8b at ``smoke`` (3 layers,
    d_model 96, 6/2 heads of 16, float32), the arch's float32 smoke
    configuration otherwise, or the full published configuration."""
    if not smoke:
        return get_config(arch)
    cfg = get_smoke_config(arch).replace(dtype="float32",
                                         param_dtype="float32")
    if arch == "llama3-8b":
        cfg = cfg.replace(n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
                          d_head=16, d_ff=192)
    return cfg


def main(argv=None, params=None):
    """Print the table; ``params`` (the model's raw weights on the device)
    stand in for the seeded ones."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the reference example's small float32 model")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = model_config(args.arch, args.smoke)
    prompt_len, max_seq, buffer = ((384, 512, 32) if args.smoke
                                   else (3072, 4096, 128))
    dev = args.device
    api = get_model(cfg)
    if params is None:
        params = api.init_params(cfg, 0, dev)
    projections = calibrate_swan(api, cfg, params,
                                 make_batch(cfg, 4, 64, device=dev))
    absorbed = api.absorb(params, cfg, projections)

    long_prompt = make_batch(cfg, 1, prompt_len, seed=5, device=dev)

    def decode_tail(sess, n=12):
        """Prefill then greedy-decode n tokens: decode reads the
        (compressed) cache, so compression error shows up here (prefill
        logits alone are lossless by Lemma A.1)."""
        logits = sess.prefill(long_prompt)
        outs = []
        tok = torch.argmax(logits, -1)
        for _ in range(n):
            logits = sess.decode(tok)
            outs.append(logits.float())
            tok = torch.argmax(logits, -1)
        return torch.stack(outs)

    base = decode_tail(ServeSession(cfg, params, max_seq=max_seq, batch=1,
                                    device=dev))

    print(f"{'setting':>22} | {'cache MB':>9} | {'saving':>7} | "
          f"{'top1 agree':>10} | max|Δlogit| over 12 decodes")
    k_max = cfg.d_head
    for k_active in [k_max, 3 * k_max // 4, k_max // 2, k_max // 4]:
        swan = SwanConfig(k_max=k_max, buffer=buffer, mode="topk",
                          k_key=k_active, k_value=k_active)
        sess = ServeSession(cfg, absorbed, swan=swan, projections=projections,
                            max_seq=max_seq, batch=1, device=dev)
        out = decode_tail(sess)
        del sess
        err = float(torch.max(torch.abs(out - base)))
        agree = float((torch.argmax(out, -1) == torch.argmax(base, -1))
                      .float().mean())
        # memory at the allocation that k_active would need
        fp = model_cache_footprint(cfg, SwanConfig(k_max=k_active,
                                                   buffer=buffer),
                                   1, prompt_len)
        print(f"   k_active={k_active:3d}/{k_max:3d}    | "
              f"{fp.swan_bytes / 1e6:9.3f} | {fp.saving:7.1%} | "
              f"{agree:10.2f} | {err:.4f}")
    print("\nruntime knob: all four sessions share ONE set of weights and")
    print("projections; only the SwanConfig changed (no offline step).")


if __name__ == "__main__":
    main()
