"""Quickstart with the PyTorch/CUDA port: calibrate SWAN on a model and
serve with a compressed cache.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch llama3-8b] \
        [--smoke] [--device cpu]

The counterpart of ``examples/quickstart.py``, on the card by default:
  1. build a model of the dense family (seeded random weights),
  2. offline calibration -> joint-SVD projections (paper §4.1),
  3. absorb P_VO into W_V/W_O (lossless, §4.2),
  4. serve with the hybrid winnowed cache at 50% retention (§4.3),
  5. report the memory saving (Eq. 1 applied to the whole model),
  6. check that full retention reproduces the dense model.
``--smoke`` takes the arch's small float32 configuration (the reference
example's own model for llama3-8b); without it the full published
configuration runs in bf16 with a 512-token prompt.
"""
import argparse
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import (ARCH_IDS, SwanConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.launch.io import make_batch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.runtime.serve_loop import (ServeSession,  # noqa: E402
                                            calibrate_swan)


def main(argv=None, params=None):
    """Run the walk-through; ``params`` (the arch's raw weights on the
    device) stand in for the seeded ones."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's small float32 configuration")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        cfg = get_smoke_config(args.arch).replace(dtype="float32",
                                                  param_dtype="float32")
        prompt_len, max_seq, buffer = 16, 128, 8
    else:
        cfg = get_config(args.arch)
        prompt_len, max_seq, buffer = 512, 1024, 128
    dev = args.device
    api = get_model(cfg)
    print(f"model: {cfg.name}  d_head={cfg.d_head}  kv_heads={cfg.n_kv_heads}")

    if params is None:
        params = api.init_params(cfg, 0, dev)

    # --- 1. offline calibration (one forward pass over calibration data) ---
    calib = make_batch(cfg, batch=2, seq=32, seed=7, device=dev)
    projections = calibrate_swan(api, cfg, params, calib)
    print(f"calibrated projections: p_qk {tuple(projections['p_qk'].shape)}")

    # --- 2. absorb the value-side rotation into the weights (lossless) -----
    absorbed = api.absorb(params, cfg, projections)

    # --- 3. serve with a compressed cache -----------------------------------
    swan = SwanConfig(k_max=cfg.d_head // 2, buffer=buffer, mode="topk")
    sess = ServeSession(cfg, absorbed, swan=swan, projections=projections,
                        max_seq=max_seq, batch=2, device=dev)
    prompt = make_batch(cfg, batch=2, seq=prompt_len, seed=1, device=dev)
    out = sess.generate(prompt, n_tokens=16)
    print("generated token ids:", out[0].tolist())

    # --- 4. memory accounting (paper Eq. 1) ---------------------------------
    rep = sess.cache_report()
    print(f"cache: {rep['mode']}  {rep['bytes'] / 1e6:.2f} MB "
          f"(dense would be {rep['dense_bytes'] / 1e6:.2f} MB -> "
          f"{rep['saving']:.0%} saving)")
    del sess

    # --- 5. sanity: full retention reproduces the dense model --------------
    exact = SwanConfig(k_max=cfg.d_head, buffer=buffer, mode="topk")
    s_dense = ServeSession(cfg, params, max_seq=max_seq, batch=2, device=dev)
    s_exact = ServeSession(cfg, absorbed, swan=exact, projections=projections,
                           max_seq=max_seq, batch=2, device=dev)
    a = s_dense.generate(prompt, 12)
    b = s_exact.generate(prompt, 12)
    agree = float((a == b).float().mean())
    if cfg.dtype == "float32":
        assert bool(torch.equal(a, b)), "full-retention SWAN must match dense"
        print("losslessness check (Lemmas A.1/A.2): PASS")
    else:   # bf16 rounding may flip a near-tie: report the agreement
        print(f"losslessness check (Lemmas A.1/A.2, {cfg.dtype}): "
              f"{agree:.0%} of greedy tokens equal to dense")


if __name__ == "__main__":
    main()
