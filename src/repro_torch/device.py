"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for and
    absent: the port never falls back to the CPU without being told to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the port's plain PyTorch path on the CPU")
    return dev


@contextmanager
def f32_matmul() -> Iterator[None]:
    """Full-f32 matrix products on the card inside the block (TF32 off, as
    torch's default is), whatever the caller set: the kernels' plain twins
    compute in f32 so that the kernels can be held to them tightly."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
