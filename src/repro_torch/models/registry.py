"""Model API of the port (the ``dense`` entry of ``repro.models.registry``).

Every arch of the port's registry (llama3-8b, yi-9b, olmo-1b) runs through
the one ``dense`` entry: the config's ``norm`` and ``tie_embeddings`` pick
the norm and the output head inside ``models.transformer``."""
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
        reference's ``ModelApi.loss``; differentiable in ``p``."""
        return tfm.xent_loss(self.forward(p, cfg, batch), batch["tokens"])


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


_FAMILIES = {
    "dense": ModelApi(tfm.init_lm_params, _forward, tfm.init_caches, _prefill,
                      tfm.lm_decode_step, _collect, tfm.absorb_swan,
                      tfm.init_paged_caches, _prefill_chunk),
}


def get_model(cfg) -> ModelApi:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet; "
                                  f"the port has {list(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def swan_applicable(cfg) -> bool:
    return cfg.family in _FAMILIES
