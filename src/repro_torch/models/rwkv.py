"""RWKV-6 (Finch): attention-free time mix with a data-dependent decay, and
the receptance-gated squared-ReLU channel mix.

Port of ``repro.models.rwkv``.  Per head (dk = dv = head_dim):

  y_t = r_t · (diag(u)·k_t v_tᵀ + S_t) ;   S_{t+1} = diag(w_t)·S_t + k_t v_tᵀ

with the per-channel decay ``w_t = exp(−exp(base + LoRA(x)))``.  Training
and prefill use the reference's chunked formulation (``CHUNK`` tokens): the
cumulative log-decays give an attention-like intra-chunk kernel plus an
O(1) carried state.  Its exponent ``cum_prev_t − cum_τ`` is positive for
τ >= t and can overflow there; the port masks it to -inf BEFORE the
exponential (the reference's ``where`` after it leaves 0·inf in the
backward), which gives the reference's masked 0 exactly.  Static
token-shift mixes, as in the reference (Finch's ddlerp is simplified
there).

Decode is the recurrence, one token at a time, its state updated IN PLACE;
a lane marked dead keeps its state.  Plain PyTorch: the reference leaves
the wkv to XLA, not to a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init_, torch_dtype, write_live_

Params = Dict[str, Any]

CHUNK = 64
DECAY_LORA = 64


def _stacked(cfg, L: int, d_in: int, d_out: int, gen, device, scale=None):
    w = torch.empty((L, d_in, d_out), dtype=torch_dtype(cfg.param_dtype),
                    device=device)
    for i in range(L):
        dense_init_(w[i], gen, scale)
    return w


def init_time_mix_params(cfg, n_layers: int, gen: torch.Generator,
                         device) -> Params:
    """Stacked [L, ...] time mixes with the reference's init: fan-in
    projections (w_o6 at d^-½, the LoRA's up side at 0.01), the shift mixes
    at 0.5, the base log-log decay ``-6 + 5·(i/(d-1))^0.9``, a zero bonus
    ``u`` and an identity group norm."""
    L, d = n_layers, cfg.d_model
    H, dk = cfg.n_heads, cfg.rwkv.head_dim

    def w(d_in, d_out, scale=None):
        return _stacked(cfg, L, d_in, d_out, gen, device, scale)

    def full(shape, value):
        return torch.full((L, *shape), value, dtype=torch.float32,
                          device=device)
    decay = torch.tensor([-6.0 + 5.0 * (i / max(d - 1, 1)) ** 0.9
                          for i in range(d)], dtype=torch.float32,
                         device=device)
    return {"mix": full((5, d), 0.5),         # r, k, v, g, w shift mixes
            "w_r": w(d, d), "w_k6": w(d, d), "w_v6": w(d, d), "w_g": w(d, d),
            "w_o6": w(d, d, d ** -0.5),
            "decay_w": decay.expand(L, d).contiguous(),
            "decay_lora_a": w(d, DECAY_LORA),
            "decay_lora_b": w(DECAY_LORA, d, 0.01),
            "bonus_u": full((H, dk), 0.0),
            "gn_scale": full((d,), 1.0), "gn_bias": full((d,), 0.0)}


def init_channel_mix_params(cfg, n_layers: int, gen: torch.Generator,
                            device) -> Params:
    L, d, ff = n_layers, cfg.d_model, cfg.d_ff
    return {"mix": torch.full((L, 2, d), 0.5, dtype=torch.float32,
                              device=device),   # k, r shift mixes
            "w_up": _stacked(cfg, L, d, ff, gen, device),
            "w_down": _stacked(cfg, L, ff, d, gen, device, ff ** -0.5),
            "w_r": _stacked(cfg, L, d, d, gen, device)}


def _shift_mix(x: torch.Tensor, x_prev: torch.Tensor,
               mix: torch.Tensor) -> torch.Tensor:
    """lerp(x, token-shifted x, mix).  x: [B, S, d]; x_prev: [B, 1, d]."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    return x + (shifted - x) * mix


def _heads(x: torch.Tensor, H: int, dk: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, H, dk)


def _group_norm(y: torch.Tensor, p: Params, eps: float = 64e-5
                ) -> torch.Tensor:
    """Per-head LayerNorm over dv with the POPULATION variance (RWKV's
    GroupNorm(H)).  y: [B, S, H, dv] -> [B, S, H·dv]."""
    mu = y.mean(dim=-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    yn = (y - mu) * torch.rsqrt(var + eps)
    B, S, H, dv = y.shape
    return yn.reshape(B, S, H * dv) * p["gn_scale"] + p["gn_bias"]


def _rkvgw(p: Params, cfg, x: torch.Tensor, x_prev: torch.Tensor):
    """Projections with token shift: r, k, v [B, S, H, dk], g [B, S, d],
    logw [B, S, H, dk] (negative log decays, f32)."""
    H, dk = cfg.n_heads, cfg.rwkv.head_dim
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xg, xw = (_shift_mix(x, x_prev, mix[i]) for i in range(5))
    r = _heads(xr @ p["w_r"], H, dk)
    k = _heads(xk @ p["w_k6"], H, dk)
    v = _heads(xv @ p["w_v6"], H, dk)
    g = F.silu(xg @ p["w_g"])
    lora = torch.tanh(xw @ p["decay_lora_a"]) @ p["decay_lora_b"]
    logw = -torch.exp(p["decay_w"].float() + lora.float())
    return r, k, v, g, _heads(logw, H, dk)


def _chunk_wkv(r, k, v, logw, u, h0):
    """One chunk.  r, k, v, logw: [B, Q, H, dk] (f32); u: [H, dk]; h0:
    [B, H, dk, dv].  Returns (y [B, Q, H, dv], h_out)."""
    Q = r.shape[1]
    cum = torch.cumsum(logw, dim=1)                      # Σ_{s<=t} logw_s
    cum_prev = cum - logw                                # Σ_{s<t}  logw_s
    # intra-chunk: A[t,τ] = Σ_i r_t[i] k_τ[i] exp(cum_prev_t − cum_τ)[i], τ < t
    rel = cum_prev[:, :, None] - cum[:, None, :]         # [B,t,τ,H,dk]
    not_strict = ~torch.ones((Q, Q), dtype=torch.bool,
                             device=r.device).tril(-1)
    decay = torch.exp(rel.masked_fill(not_strict[None, :, :, None, None],
                                      -math.inf))
    A = torch.einsum("bthi,bshi,btshi->bhts", r, k, decay)
    y = torch.einsum("bhts,bshj->bthj", A, v)
    y = y + torch.einsum("bthi,hi,bthi,bthj->bthj", r, u, k, v)   # bonus
    y = y + torch.einsum("bthi,bthi,bhij->bthj", r, torch.exp(cum_prev), h0)
    w_tail = torch.exp(cum[:, -1:] - cum)                # Π_{s>τ} w_s
    h_out = h0 * torch.exp(cum[:, -1])[..., None] + torch.einsum(
        "bshi,bshi,bshj->bhij", w_tail, k, v)
    return y, h_out


def time_mix_forward(p: Params, cfg, x: torch.Tensor, chunk: int = CHUNK,
                     return_state: bool = False):
    """x: [B, S, d] -> [B, S, d] (training / prefill); with
    ``return_state`` also the final wkv state [B, H, dk, dv]."""
    B, S, d = x.shape
    H, dk = cfg.n_heads, cfg.rwkv.head_dim
    r, k, v, g, logw = _rkvgw(p, cfg, x, x.new_zeros((B, 1, d)))
    rf, kf, vf = r.float(), k.float(), v.float()
    u = p["bonus_u"].float()
    # the last chunk runs short where the reference pads it (zero k adds
    # nothing, zero logw decays by 1): the same values
    h = torch.zeros((B, H, dk, dk), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        y_c, h = _chunk_wkv(rf[:, sl], kf[:, sl], vf[:, sl], logw[:, sl], u, h)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)
    out = (_group_norm(y, p).to(x.dtype) * g) @ p["w_o6"]
    return (out, h) if return_state else out


def channel_mix_forward(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    return _channel_mix(p, x, x.new_zeros((x.shape[0], 1, x.shape[2])))


def _channel_mix(p: Params, x: torch.Tensor, x_prev: torch.Tensor
                 ) -> torch.Tensor:
    mix = p["mix"].to(x.dtype)
    xk = _shift_mix(x, x_prev, mix[0])
    xr = _shift_mix(x, x_prev, mix[1])
    h = torch.square(F.relu(xk @ p["w_up"]))
    return torch.sigmoid(xr @ p["w_r"]) * (h @ p["w_down"])


# ---------------------------------------------------------------------------
# Decode (recurrent)
# ---------------------------------------------------------------------------

def init_rwkv_state(cfg, batch: int, device, lead=()) -> Params:
    """Zero decode state: the wkv state ``S`` [*lead, B, H, dk, dk] f32 and
    the two token-shift carries [*lead, B, 1, d] in ``cfg.dtype``."""
    H, dk, d = cfg.n_heads, cfg.rwkv.head_dim, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    return {"S": torch.zeros((*lead, batch, H, dk, dk), dtype=torch.float32,
                             device=device),
            "x_tm": torch.zeros((*lead, batch, 1, d), dtype=dt, device=device),
            "x_cm": torch.zeros((*lead, batch, 1, d), dtype=dt, device=device)}


def time_mix_decode(p: Params, cfg, x: torch.Tensor, state: Params,
                    live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, 1, d], one token; ``S`` and ``x_tm`` advance in place."""
    r, k, v, g, logw = _rkvgw(p, cfg, x, state["x_tm"])
    rf, kf, vf = (t.float()[:, 0] for t in (r, k, v))             # [B,H,dk]
    w = torch.exp(logw[:, 0])
    u = p["bonus_u"].float()
    S = state["S"]
    kv = kf[..., :, None] * vf[..., None, :]                       # [B,H,dk,dv]
    y = torch.einsum("bhi,bhij->bhj", rf, u[None, :, :, None] * kv + S)
    S_new = S * w[..., None] + kv
    out = (_group_norm(y[:, None], p).to(x.dtype) * g) @ p["w_o6"]
    write_live_(state["S"], S_new, live)
    write_live_(state["x_tm"], x, live)
    return out


def channel_mix_decode(p: Params, cfg, x: torch.Tensor, state: Params,
                       live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, 1, d]; ``x_cm`` advances in place."""
    out = _channel_mix(p, x, state["x_cm"])
    write_live_(state["x_cm"], x, live)
    return out
