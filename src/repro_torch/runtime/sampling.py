"""Token sampling (port of ``repro.runtime.sampling``).

Logits are cast to float32 BEFORE the temperature divide.  Greedy
decoding matches the reference token for token; temperature sampling
draws from an explicit ``torch.Generator`` and cannot reproduce
``jax.random.categorical``'s draws.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (``temperature <= 0``, first maximum on ties) or temperature
    sampling over ``logits [B, V]``; returns int64 token ids [B]."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
