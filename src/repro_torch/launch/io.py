"""Concrete batches (port of ``repro.launch.io.make_batch``).

Everything comes from ``numpy.random.default_rng(seed)`` in the
reference's order -- the tokens, then a VLM's patch embeddings, then an
encoder-decoder's frame embeddings -- so both packages see the same batch
for the same seed.  The embeddings are float64 draws times 0.02, rounded
to the config's dtype through float32, as ``jnp.asarray`` rounds them
with 64-bit types off (a direct float64 -> bfloat16 cast can round the
other way)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import torch_dtype


def make_batch(cfg, batch: int, seq: int, seed: int = 0,
               device: DeviceLike = None) -> Dict[str, Any]:
    """``{"tokens": [batch, seq] int64}``, plus ``"prefix_embeds"``
    [batch, n_prefix_tokens, d_model] for a VLM and ``"frames"`` [batch,
    encoder_seq, d_model] for an encoder-decoder, in ``cfg.dtype``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq))
    out = {"tokens": torch.as_tensor(tokens, dtype=torch.int64, device=dev)}

    def embeds(n):
        x = (rng.standard_normal((batch, n, cfg.d_model)) * 0.02
             ).astype(np.float32)
        return torch.from_numpy(x).to(dev, torch_dtype(cfg.dtype))
    if cfg.family == "vlm":
        out["prefix_embeds"] = embeds(cfg.n_prefix_tokens)
    if cfg.is_encoder_decoder:
        out["frames"] = embeds(cfg.encoder_seq)
    return out
