"""Model API of the port (the six families of ``repro.models.registry``).

The first three run through the same transformer adapters, as in the
reference: the dense archs (llama3-8b, yi-9b, olmo-1b), whose ``norm``
and ``tie_embeddings`` pick the norm and the output head, the MoE archs
(deepseek-moe-16b, qwen2-moe-a2.7b), whose ``moe`` puts the experts of
``models.moe`` in place of the MLP, and the VLM (internvl2-1b), whose
batches may carry ``prefix_embeds`` ahead of the tokens.  The
encoder-decoder (whisper-small) runs through ``models.encdec`` on batches
that carry ``frames``; the hybrid (jamba-1.5-large-398b) through
``models.jamba`` and the attention-free ``ssm`` family (rwkv6-3b) through
``models.rwkv_model``.  Like the reference's, these three have no paged
state and no chunked prefill, and the ``ssm`` family has no calibration
capture and no absorption (``collect_qkv``/``absorb`` None): SWAN is
inapplicable to it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.models import encdec, jamba, rwkv_model
from repro_torch.models import transformer as tfm


@dataclass(frozen=True)
class ModelApi:
    init_params: Callable        # (cfg, seed, device) -> params
    forward_aux: Callable        # (p, cfg, batch) -> (logits, aux) (differentiable)
    init_serve_state: Callable   # (cfg, swan, batch, max_seq, device) -> state
    prefill: Callable            # (p, cfg, batch, state, swan, proj, ...) -> (logits, state)
    decode_step: Callable        # (p, cfg, token, pos, state, swan, proj, ...) -> (logits, state)
    # (p, cfg, batch) -> (q, k, v, wo); None where SWAN is inapplicable
    collect_qkv: Optional[Callable]
    absorb: Optional[Callable]   # (p, cfg, projections) -> params
    # (cfg, swan, batch, max_seq, n_pages, page_size, device) -> paged
    # state; None where the family has no paged layout (encdec, hybrid,
    # ssm)
    init_paged_state: Optional[Callable] = None
    # (p, cfg, batch, state, slot [P], start [P], swan, proj, ...) ->
    # (logits [P, V], state): one chunk for each of P slots' prefills; None
    # where the family cannot resume a prefill mid-prompt (encdec, and the
    # recurrent state of hybrid and ssm)
    prefill_chunk: Optional[Callable] = None

    def forward(self, p, cfg, batch):
        """Logits of ``batch`` (a VLM's prefix positions included)."""
        return self.forward_aux(p, cfg, batch)[0]

    def loss(self, p, cfg, batch):
        """(loss, {"nll", "aux", "z"}) of ``batch["tokens"]``, the
        reference's ``ModelApi.loss`` (the MoE aux loss included, a VLM's
        prefix positions left out); differentiable in ``p``."""
        logits, aux = self.forward_aux(p, cfg, batch)
        return tfm.xent_loss(logits, batch["tokens"], aux)


def _forward_aux(p, cfg, batch):
    return tfm.lm_forward_aux(p, cfg, batch["tokens"],
                              batch.get("prefix_embeds"))


def _prefill(p, cfg, batch, state, swan=None, proj=None, k_active=None,
             true_len=None):
    return tfm.lm_prefill(p, cfg, batch["tokens"], state, swan, proj,
                          batch.get("prefix_embeds"), k_active=k_active,
                          true_len=true_len)


def _prefill_chunk(p, cfg, batch, state, slot, start, swan=None, proj=None,
                   k_active=None, true_len=None, page_tab=None,
                   prefix_len=None):
    return tfm.lm_prefill_chunk_batched(p, cfg, batch["tokens"], state, slot,
                                        start, swan, proj, k_active=k_active,
                                        true_len=true_len, page_tab=page_tab,
                                        prefix_len=prefix_len)


def _collect(p, cfg, batch):
    return tfm.collect_qkv(p, cfg, batch["tokens"], batch.get("prefix_embeds"))


def _encdec_forward_aux(p, cfg, batch):
    return encdec.lm_forward_aux(p, cfg, batch["tokens"], batch["frames"])


def _encdec_prefill(p, cfg, batch, state, swan=None, proj=None):
    return encdec.prefill(p, cfg, batch["tokens"], state, swan, proj,
                          frames=batch["frames"])


def _encdec_collect(p, cfg, batch):
    return encdec.collect_qkv(p, cfg, batch["tokens"], batch["frames"])


def _jamba_forward_aux(p, cfg, batch):
    return jamba.lm_forward_aux(p, cfg, batch["tokens"])


def _jamba_prefill(p, cfg, batch, state, swan=None, proj=None):
    return jamba.prefill(p, cfg, batch["tokens"], state, swan, proj)


def _jamba_collect(p, cfg, batch):
    return jamba.collect_qkv(p, cfg, batch["tokens"])


def _rwkv_forward_aux(p, cfg, batch):
    return rwkv_model.lm_forward_aux(p, cfg, batch["tokens"])


def _rwkv_prefill(p, cfg, batch, state, swan=None, proj=None):
    return rwkv_model.prefill(p, cfg, batch["tokens"], state, swan, proj)


_TRANSFORMER = ModelApi(tfm.init_lm_params, _forward_aux, tfm.init_caches,
                        _prefill, tfm.lm_decode_step, _collect,
                        tfm.absorb_swan, tfm.init_paged_caches,
                        _prefill_chunk)
_FAMILIES = {"dense": _TRANSFORMER, "moe": _TRANSFORMER, "vlm": _TRANSFORMER,
             "encdec": ModelApi(encdec.init_lm_params, _encdec_forward_aux,
                                encdec.init_serve_state, _encdec_prefill,
                                encdec.decode_step, _encdec_collect,
                                encdec.absorb_swan),
             "hybrid": ModelApi(jamba.init_lm_params, _jamba_forward_aux,
                                jamba.init_serve_state, _jamba_prefill,
                                jamba.decode_step, _jamba_collect,
                                jamba.absorb_swan),
             "ssm": ModelApi(rwkv_model.init_lm_params, _rwkv_forward_aux,
                             rwkv_model.init_serve_state, _rwkv_prefill,
                             rwkv_model.decode_step, None, None)}


def get_model(cfg) -> ModelApi:
    return _FAMILIES[cfg.family]


def swan_applicable(cfg) -> bool:
    return get_model(cfg).collect_qkv is not None
