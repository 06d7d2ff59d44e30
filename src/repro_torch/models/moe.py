"""Mixture-of-experts FFN with routed and shared experts.

Port of ``repro.models.moe``: the capacity-based scatter/gather dispatch

  1. router logits (float32) -> top-k experts per token, gates renormalised;
  2. each (token, slot) assignment's position in its expert from a
     cumulative sum over the flattened assignment order; assignments past
     an expert's capacity C are dropped;
  3. tokens scattered into an [E, C, d] buffer, batched expert products,
     gathered back weighted by the gates, plus the shared experts.

Every shape follows the token count alone and nothing is read back to the
host, so the serve dispatches that run it can be captured in a CUDA graph:
dropped assignments write a sacrificial slot C (the only index that can
repeat), and each token's K expert outputs are summed in slot order (no
atomics), so a graph replay equals the eager call bit for bit.

Parameters (one layer; the stacked layout prepends [L]):
  router [d, E] float32;  w_gate/w_up [E, d, dx];  w_down [E, dx, d];
  shared/{w_gate, w_up [d, S·dx], w_down [S·dx, d]} (the S shared experts
  fused into one wide FFN).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import act_fn, dense_init_, torch_dtype

Params = Dict[str, Any]

NO_DROP_MAX_ASSIGNMENTS = 4096    # no_drop: capacity T·K up to this many


def init_moe_params(cfg, n_layers: int, gen: torch.Generator,
                    device) -> Params:
    """The stacked [L, ...] experts of ``n_layers`` MoE layers, with the
    reference's init distributions (truncated-normal fan-in; ``w_down``
    scaled by its own fan-in), drawn from ``gen`` layer by layer."""
    m = cfg.moe
    L, d, dx, E = n_layers, cfg.d_model, m.d_expert, m.n_routed
    pdt = torch_dtype(cfg.param_dtype)

    def stacked(*shape, scale=None, dtype=pdt):
        w = torch.empty((L, *shape), dtype=dtype, device=device)
        for i in range(L):
            dense_init_(w[i], gen, scale)
        return w

    p: Params = {"router": stacked(d, E, dtype=torch.float32),
                 "w_gate": stacked(E, d, dx), "w_up": stacked(E, d, dx),
                 "w_down": stacked(E, dx, d, scale=dx ** -0.5)}
    if m.n_shared:
        ds = m.n_shared * dx
        p["shared"] = {"w_gate": stacked(d, ds), "w_up": stacked(d, ds),
                       "w_down": stacked(ds, d, scale=ds ** -0.5)}
    return p


def capacity(cfg, n_tokens: int, no_drop: bool) -> int:
    """Token capacity C of each expert for ``n_tokens`` tokens (the
    reference's rule).  ``no_drop`` (serving) gives C = T·K, so nothing is
    dropped, while T·K <= 4096; past that a doubled capacity factor."""
    m = cfg.moe
    if no_drop and n_tokens * m.top_k <= NO_DROP_MAX_ASSIGNMENTS:
        return n_tokens * m.top_k
    cf = m.capacity_factor * (2.0 if no_drop else 1.0)
    return max(int(cf * n_tokens * m.top_k / m.n_routed), 1)


def route(p: Params, cfg, tokens: torch.Tensor, no_drop: bool):
    """tokens [T, d] -> (logits [T, E] f32, probs [T, E], gates [T, K]
    renormalised, expert [T, K], slot [T·K] position in its expert (C for a
    dropped assignment), keep [T·K], C)."""
    m = cfg.moe
    E, K = m.n_routed, m.top_k
    T = tokens.shape[0]
    logits = tokens.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gates, expert = torch.topk(probs, K, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    C = capacity(cfg, T, no_drop)
    flat_e = expert.reshape(-1)                                   # [T·K]
    onehot = (flat_e[:, None] == torch.arange(E, device=flat_e.device)
              ).to(torch.int32)                                   # [T·K, E]
    rank = torch.cumsum(onehot, dim=0, dtype=torch.int32)         # 1-based
    pos = rank.gather(1, flat_e[:, None])[:, 0].long() - 1
    keep = pos < C
    slot = torch.where(keep, pos, torch.full_like(pos, C))
    return logits, probs, gates, expert, slot, keep, C


def moe_forward(p: Params, cfg, x: torch.Tensor, no_drop: bool = False,
                with_aux: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (y [B, S, d], {"moe_load_balance", "moe_router_z"}).

    ``no_drop=True`` is the serving rule (``capacity``): prefill and
    incremental decode agree exactly while T·K <= 4096.  The training
    forward drops at the config's capacity factor; which assignments drop
    follows the flattened (token, slot) order, padding included.  The
    serve paths pass ``with_aux=False``: no aux losses are computed and
    the dict is empty."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, K = B * S, m.n_routed, m.top_k
    act = act_fn(cfg.act)
    tokens = x.reshape(T, d)
    logits, probs, gates, expert, slot, keep, C = route(p, cfg, tokens,
                                                        no_drop)
    flat_e = expert.reshape(-1)

    buf = tokens.new_zeros((E, C + 1, d))
    buf = buf.index_put((flat_e, slot),
                        tokens[:, None].expand(T, K, d).reshape(T * K, d))
    buf = buf[:, :C]                                              # [E, C, d]
    h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out = torch.bmm(h, p["w_down"])                               # [E, C, d]

    out = torch.cat([out, out.new_zeros((E, 1, d))], dim=1)       # slot C -> 0
    gathered = out[flat_e, slot]                                  # [T·K, d]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    w = gates.reshape(-1, 1).to(gathered.dtype)
    y = (gathered * w).view(T, K, d).sum(1)

    if "shared" in p:
        sp = p["shared"]
        hs = act(tokens @ sp["w_gate"]) * (tokens @ sp["w_up"])
        y = y + hs @ sp["w_down"]
    if not with_aux:
        return y.reshape(B, S, d), {}

    routed = (expert[..., None] == torch.arange(E, device=x.device)).float()
    me = routed.mean(dim=(0, 1))                                  # fraction routed
    pe = probs.mean(dim=0)                                        # mean router prob
    aux = {"moe_load_balance": E * torch.sum(me * pe) * m.router_aux_weight,
           "moe_router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
           * m.router_z_weight}
    return y.reshape(B, S, d), aux
