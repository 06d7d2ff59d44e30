"""Mamba-1 selective SSM block (Jamba's sequence mixer).

Port of ``repro.models.mamba``.  Diagonal selective SSM:
``h_t = exp(Δ_t·A) h_{t-1} + Δ_t·B_t x_t``, ``y_t = C_t·h_t + D·x_t``, with
input-dependent Δ, B, C.

The training and prefill forward is the reference's chunked formulation:
A is diagonal, so the transition from τ to t within a chunk is
``exp(A (s_t - s_τ))`` with ``s`` the running sum of Δ; each chunk adds an
attention-like intra-chunk term to the carried state's contribution.  Three
departures, none of which changes a forward value:

  * the exponent is masked BEFORE the exponential: above the diagonal
    ``(s_t - s_τ)·A`` is positive and overflows, and the reference's
    ``where`` after ``exp`` leaves 0·inf in the backward (non-finite
    gradients once a chunk is long enough); here those entries are -inf,
    whose exponential is exactly the reference's masked 0;
  * the intra-chunk ``[B, Q, Q, D, N]`` term is computed in blocks of
    channels (the recurrence is diagonal in them) and tiles of query rows
    that stop at the diagonal, so no intermediate passes
    ``INTRA_BLOCK_BYTES`` (at jamba's full width one chunk of the
    reference's intermediate is 68.7 GB) and the masked upper tiles are
    never computed (56 % of the square's elements at Q = 128);
  * the last chunk runs short where the reference pads it with zero Δ
    (padding adds exact zeros to every real position's sums).

``mamba_forward(..., return_state=True)`` also returns the recurrent state
after the last token (the scan's own final ``h`` and the conv tail), which
the reference rebuilds with a second scan (``jamba._mamba_state_from_prefill``).

Decode keeps the recurrent state explicitly, O(1) per step, and updates it
IN PLACE; a lane marked dead keeps its state.  It is plain PyTorch, as the
reference leaves it to XLA: the scan was never a Pallas kernel.

Parameters of one layer (a stacked layout prepends its [L]):
  w_in [d, 2·d_in]; conv_w [d_conv, d_in]; conv_b [d_in]; w_x [d_in, R+2N];
  w_dt [R, d_in]; dt_bias [d_in] f32; a_log [d_in, N] f32; d_skip [d_in]
  f32; w_out [d_in, d].
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init_, torch_dtype, write_live_
from repro_torch.sharding.api import shard

Params = Dict[str, Any]

CHUNK = 128
INTRA_TILE = 16                 # query rows per tile of the intra-chunk term
INTRA_BLOCK_BYTES = 2 << 30     # the largest [B, tile, Q, Dc, N] f32 tile


def dt_rank(cfg) -> int:
    return cfg.mamba.dt_rank or -(-cfg.d_model // 16)


def init_mamba_params(cfg, n_layers: int, gen: torch.Generator,
                      device) -> Params:
    """The stacked [L, ...] parameters of ``n_layers`` Mamba blocks with the
    reference's init distributions: fan-in projections, a normal conv of
    scale d_conv^-½, S4D-real ``a_log = log(1..N)``, ``dt_bias`` the
    inverse softplus of Δ drawn log-uniformly in [1e-3, 1e-1], D = 1."""
    m = cfg.mamba
    L, d, d_in = n_layers, cfg.d_model, m.expand * cfg.d_model
    R, N = dt_rank(cfg), m.d_state
    pdt = torch_dtype(cfg.param_dtype)

    def stacked(*shape, scale=None):
        w = torch.empty((L, *shape), dtype=pdt, device=device)
        for i in range(L):
            dense_init_(w[i], gen, scale)
        return w

    conv = torch.empty((L, m.d_conv, d_in), dtype=torch.float32,
                       device=device).normal_(generator=gen)
    u = torch.empty((L, d_in), dtype=torch.float32, device=device
                    ).uniform_(generator=gen)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001))
                        + math.log(0.001))
    a = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "w_in": stacked(d, 2 * d_in),
        "conv_w": conv.to(pdt) * (m.d_conv ** -0.5),
        "conv_b": torch.zeros((L, d_in), dtype=pdt, device=device),
        "w_x": stacked(d_in, R + 2 * N),
        "w_dt": stacked(R, d_in, scale=R ** -0.5),
        "dt_bias": torch.log(torch.expm1(dt_init)),
        "a_log": torch.log(a).expand(L, d_in, N).contiguous(),
        "d_skip": torch.ones((L, d_in), dtype=torch.float32, device=device),
        "w_out": stacked(d_in, d, scale=d_in ** -0.5),
    }


def _ssm_inputs(p: Params, cfg, u: torch.Tensor):
    """u [B, S, d_in] (post-conv, post-silu) -> (Δ [B, S, d_in], B, C
    [B, S, N]), all float32."""
    N, R = cfg.mamba.d_state, dt_rank(cfg)
    xdbc = u @ p["w_x"]
    dt_r, Bm, Cm = torch.split(xdbc, [R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["w_dt"] + p["dt_bias"].to(xdbc.dtype))
    return dt.float(), Bm.float(), Cm.float()


def _causal_conv(p: Params, cfg, u: torch.Tensor):
    """Depthwise causal conv of u [B, S, d_in] -> (silu(conv(u)), the
    zero-padded input, whose last d_conv - 1 rows are the decode tail)."""
    S, dc = u.shape[1], cfg.mamba.d_conv
    upad = F.pad(u, (0, 0, dc - 1, 0))
    acc = 0
    for i in range(dc):
        acc = acc + upad[:, i:i + S] * p["conv_w"][i]
    return F.silu(acc + p["conv_b"]), upad


def _block_channels(dt: torch.Tensor, rows: int, N: int) -> int:
    """Channels per block so that a [B, rows, Q, Dc, N] f32 tile of
    ``dt`` [B, Q, D] stays under ``INTRA_BLOCK_BYTES`` on the device that
    holds it: a DTensor's (the dry-run's) by its local shard, its block
    then as many global channels (one block when the shard fits)."""
    _, Q, D = dt.shape
    loc = getattr(dt, "_local_tensor", dt)
    Bl, _, Dl = loc.shape
    per = max(1, min(Dl, INTRA_BLOCK_BYTES // (Bl * rows * Q * N * 4)))
    return per * (D // max(Dl, 1))


def _intra(s_b, A_b, cb, x_b, upper):
    """The intra-chunk term of one block of channels, in tiles of
    ``INTRA_TILE`` query rows t, each over the keys τ <= its last row only
    (the tiles above the diagonal are masked zeros, never computed):
    ``Σ_τ Σ_n C_t·B_τ·exp(A (s_t - s_τ))·(Δu)_τ``.  Each element is the
    reference's; a row's sum leaves out only those zeros."""
    Q = s_b.shape[1]
    ys = []
    for t0 in range(0, Q, INTRA_TILE):
        t1 = min(t0 + INTRA_TILE, Q)
        rel = s_b[:, t0:t1, None] - s_b[:, None, :t1]            # [B,qt,t1,Dc]
        mask = upper[t0:t1, :t1]
        if not torch.is_grad_enabled():
            # A < 0: an infinite rel is a -inf exponent (no autograd here,
            # so the mask can go on the 4-D rel, a pass less on the 5-D one)
            rel.masked_fill_(mask[None, :, :, None], math.inf)
            decay = (rel[..., None] * A_b).exp_()                # [B,qt,t1,Dc,N]
        else:
            decay = torch.exp((rel[..., None] * A_b).masked_fill(
                mask[None, :, :, None, None], -math.inf))
        kernel = torch.einsum("btsdn,btsn->btsd", decay, cb[:, t0:t1, :t1])
        del rel, decay
        ys.append(torch.einsum("btsd,bsd->btd", kernel, x_b[:, :t1]))
    return torch.cat(ys, dim=1)


def _chunk_scan(dt, A, Bm, Cm, u, h0):
    """One chunk of the diagonal SSM, parallel over time within the chunk.

    dt, u: [B, Q, D]; Bm, Cm: [B, Q, N]; A: [D, N]; h0: [B, D, N] (all
    float32).  Returns (y [B, Q, D], h_out [B, D, N]).  Each block of
    channels computes the reference's terms on its slice: the intra-chunk
    kernel ``Σ_n C_t·exp(A (s_t - s_τ))·B_τ`` over τ <= t (``_intra``),
    the carried state's contribution ``exp(A s_t)·C_t·h0``, and the new
    state."""
    Q, D = dt.shape[1:]
    N = A.shape[1]
    s = torch.cumsum(dt, dim=1)                                  # [B,Q,D]
    x = dt * u                                                   # Δ·u
    upper = ~torch.ones((Q, Q), dtype=torch.bool, device=dt.device).tril()
    cb = Cm[:, :, None, :] * Bm[:, None, :, :]                   # [B,Q,Q,N]
    Dc = _block_channels(dt, min(Q, INTRA_TILE), N)
    ys, hs = [], []
    for d0 in range(0, D, Dc):
        sl = slice(d0, d0 + Dc)
        s_b, A_b, x_b = s[..., sl], A[sl], x[..., sl]
        y = _intra(s_b, A_b, cb, x_b, upper)
        dA = s_b[..., None] * A_b                                # [B,Q,Dc,N]
        y = y + torch.einsum("btdn,bdn->btd", torch.exp(dA) * Cm[:, :, None],
                             h0[:, sl])
        x_in = x_b[..., None] * Bm[:, :, None, :]                # [B,Q,Dc,N]
        w = x_in * torch.exp(-dA + dA[:, -1:])                   # exp(A(s_Q - s_τ))
        hs.append(h0[:, sl] * torch.exp(dA[:, -1]) + w.sum(dim=1))
        ys.append(y)
    return torch.cat(ys, dim=-1), torch.cat(hs, dim=1)


def mamba_forward(p: Params, cfg, x: torch.Tensor, chunk: int = CHUNK,
                  return_state: bool = False):
    """Training / prefill forward.  x: [B, S, d] -> y [B, S, d], or with
    ``return_state`` (y, {"h" [B, d_in, N] f32, "conv" [B, d_conv-1, d_in]
    in ``cfg.dtype``}): the state a token-by-token decode would hold after
    the last token.  Differentiable in ``p``."""
    B, S, d = x.shape
    m = cfg.mamba
    d_in = m.expand * d
    u, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    u, upad = _causal_conv(p, cfg, shard(u, "mamba_inner"))
    dt, Bm, Cm = _ssm_inputs(p, cfg, u)
    A = -torch.exp(p["a_log"])
    uf = u.float()

    # the reference pads the last chunk with zero Δ (an identity step with
    # no input, adding exact zeros to every real position's sums); the
    # port runs it short instead, which computes the same values
    h = torch.zeros((B, d_in, m.d_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        y_c, h = _chunk_scan(dt[:, sl], A, Bm[:, sl], Cm[:, sl], uf[:, sl],
                             h)
        ys.append(y_c)
    y = torch.cat(ys, dim=1) + uf * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["w_out"]
    if not return_state:
        return out
    tail = upad[:, upad.shape[1] - (m.d_conv - 1):]
    return out, {"h": h, "conv": tail.to(torch_dtype(cfg.dtype))}


# ---------------------------------------------------------------------------
# Decode (recurrent state)
# ---------------------------------------------------------------------------

def init_mamba_state(cfg, batch: int, device, lead: Tuple[int, ...] = ()
                     ) -> Params:
    """Zero decode state: ``h`` [*lead, B, d_in, N] f32 and the conv tail
    ``conv`` [*lead, B, d_conv - 1, d_in] in ``cfg.dtype``."""
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    return {"h": torch.zeros((*lead, batch, d_in, m.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((*lead, batch, m.d_conv - 1, d_in),
                                dtype=torch_dtype(cfg.dtype), device=device)}


def mamba_decode_step(p: Params, cfg, x: torch.Tensor, state: Params,
                      live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, 1, d] -> [B, 1, d]; ``state`` is advanced IN PLACE, except on
    the lanes where ``live`` [B] (bool) is False: those keep theirs."""
    u, z = torch.chunk(x @ p["w_in"], 2, dim=-1)                 # [B,1,d_in]
    win = torch.cat([state["conv"], u], dim=1)                   # [B,d_conv,d_in]
    u1 = F.silu((win * p["conv_w"][None]).sum(dim=1) + p["conv_b"])[:, None]
    dt, Bm, Cm = _ssm_inputs(p, cfg, u1)
    A = -torch.exp(p["a_log"])
    dA = torch.exp(dt[:, 0, :, None] * A[None])                  # [B,d_in,N]
    uf = u1[:, 0].float()
    h = state["h"] * dA + (dt[:, 0] * uf)[..., None] * Bm[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0]) + uf * p["d_skip"]
    y = y[:, None].to(x.dtype) * F.silu(z)
    write_live_(state["h"], h, live)
    write_live_(state["conv"], win[:, 1:], live)
    return y @ p["w_out"]


def mamba_reference(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Token-level sequential oracle (tests)."""
    state = init_mamba_state(cfg, x.shape[0], x.device)
    return torch.cat([mamba_decode_step(p, cfg, x[:, t:t + 1], state)
                      for t in range(x.shape[1])], dim=1)
