"""Model API of the port (the ``dense`` and ``moe`` entries of
``repro.models.registry``).

Both families run through the same transformer adapters, as in the
reference: the dense archs (llama3-8b, yi-9b, olmo-1b), whose ``norm`` and
``tie_embeddings`` pick the norm and the output head, and the MoE archs
(deepseek-moe-16b, qwen2-moe-a2.7b), whose ``moe`` puts the experts of
``models.moe`` in place of the MLP."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.models import transformer as tfm


@dataclass(frozen=True)
class ModelApi:
    init_params: Callable        # (cfg, seed, device) -> params
    forward: Callable            # (p, cfg, batch) -> logits (differentiable)
    init_serve_state: Callable   # (cfg, swan, batch, max_seq, device) -> state
    prefill: Callable            # (p, cfg, batch, state, swan, proj, k_active, true_len) -> (logits, state)
    decode_step: Callable        # (p, cfg, token, pos, state, swan, proj, k_active, page_tab) -> (logits, state)
    collect_qkv: Callable        # (p, cfg, batch) -> (q, k, v, wo)
    absorb: Callable             # (p, cfg, projections) -> params
    # (cfg, swan, batch, max_seq, n_pages, page_size, device) -> paged state
    init_paged_state: Callable
    # (p, cfg, batch, state, slot [P], start [P], swan, proj, ...) ->
    # (logits [P, V], state): one chunk for each of P slots' prefills
    prefill_chunk: Callable

    def loss(self, p, cfg, batch):
        """(loss, {"nll", "aux", "z"}) of ``batch["tokens"]``, the
        reference's ``ModelApi.loss`` (the MoE aux loss included);
        differentiable in ``p``."""
        logits, aux = tfm.lm_forward_aux(p, cfg, batch["tokens"])
        return tfm.xent_loss(logits, batch["tokens"], aux)


def _forward(p, cfg, batch):
    return tfm.lm_forward(p, cfg, batch["tokens"])


def _prefill(p, cfg, batch, state, swan=None, proj=None, k_active=None,
             true_len=None):
    return tfm.lm_prefill(p, cfg, batch["tokens"], state, swan, proj,
                          k_active=k_active, true_len=true_len)


def _prefill_chunk(p, cfg, batch, state, slot, start, swan=None, proj=None,
                   k_active=None, true_len=None, page_tab=None,
                   prefix_len=None):
    return tfm.lm_prefill_chunk_batched(p, cfg, batch["tokens"], state, slot,
                                        start, swan, proj, k_active=k_active,
                                        true_len=true_len, page_tab=page_tab,
                                        prefix_len=prefix_len)


def _collect(p, cfg, batch):
    return tfm.collect_qkv(p, cfg, batch["tokens"])


_TRANSFORMER = ModelApi(tfm.init_lm_params, _forward, tfm.init_caches,
                        _prefill, tfm.lm_decode_step, _collect,
                        tfm.absorb_swan, tfm.init_paged_caches,
                        _prefill_chunk)
_FAMILIES = {"dense": _TRANSFORMER, "moe": _TRANSFORMER}


def get_model(cfg) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet; "
                                  f"the port has {list(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def swan_applicable(cfg) -> bool:
    return cfg.family in _FAMILIES
