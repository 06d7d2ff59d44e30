"""PyTorch/CUDA port of the SWAN serving stack (``repro`` is the JAX reference).

The port keeps the reference's tensor layouts at every public function
(stacked ``[L, ...]`` layer leaves, hybrid cache ``[B, Kv, S, k]``, ring
``[B, Kv, b, dh]``) so the parity tests compare like with like.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; there is
no silent CPU fallback (``repro_torch.device.resolve_device``).
"""
