"""Two serve engines' transcripts held against each other at bf16.

Two engines that differ only in how the host lays out a step (the data
shards of a mesh, the lanes of a chunk dispatch) compute the same function,
but a bf16 product's rounding may follow the shape of the batch it runs in,
so their greedy transcripts can part at a near-tie.  :func:`compare` holds
two runs to what such rounding can explain:

* at each parting token, the two runs' logits of the two chosen tokens
  agree within ``LOGIT_TOL`` and the first run's top-two margin, and its
  margin between the two choices, are below it: a near-tie, not a wrong
  row;
* over every token both runs read from the same context (each request's
  tokens up to and including its parting token) the largest logit
  difference anywhere in the vocabulary row stays within ``row_tol``.

``record_logits`` keeps, by (request, token index), the logits row each
token of an engine is read from; ``pad_chunk_lanes`` makes a one-shard
engine run a sharded engine's chunk lane counts (the witness that the two
differ by those counts alone).  ``chip_smoke.py``'s ``sharded`` phase and
``bench_sharded_serve`` on the card gate with it.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Tuple

import numpy as np
import torch

LOGIT_TOL = 5e-2     # bf16 (the reference's tests/test_kernels.py:28)
# whole-row limit at bf16, llama3-8b at full width on the H100: two data
# shards and one differ by 0.086 at most (a chunk run at 1 lane against 2),
# a shard's dropped lane offset by 2.7-8.2 (PERF.md, §6, the sharded engine)
ROW_TOL = 0.25

Rows = Dict[Tuple[str, int], torch.Tensor]
Tokens = Dict[str, List[int]]


def record_logits(eng, rows: Rows) -> None:
    """Keep in ``rows``, by (request, token index), the float32 CPU copy of
    the logits row every token of ``eng`` is read from at its synchronous
    token fetch (an engine without ``async_fetch``).  The hook holds the
    engine weakly: no reference cycle keeps a deleted engine (and its CUDA
    graphs) alive until a later collection."""
    orig, ref = type(eng)._lane_tokens, weakref.ref(eng)

    def lane_tokens(src, logits, greedy, picks):
        for lane, req, draw in picks:
            rows[(req.uid, draw)] = logits[lane].float().cpu()
        return orig(ref(), src, logits, greedy, picks)
    eng._lane_tokens = lane_tokens


def pad_chunk_lanes(eng, n: int) -> None:
    """Pad every chunk dispatch of ``eng`` to at least ``n`` lanes with dead
    lanes (parked at ``n_local``, one token at position 0), as a dispatch
    over ``[dp, P_local]`` lanes always has ``dp`` at least: a one-shard
    engine then runs a ``dp``-shard engine's lane counts."""
    orig = type(eng)._chunk_call
    ref = weakref.ref(eng)

    def call(toks, slot, start, tlen, k, width, prefix):
        e, m = ref(), n - toks.shape[0]
        if m > 0:
            def pad(x, fill):
                return np.concatenate(
                    [x, np.full((m, *x.shape[1:]), fill, x.dtype)])
            toks, slot, start, tlen, k = (
                pad(toks, 0), pad(slot, e.n_local), pad(start, 0),
                pad(tlen, 1), pad(k, e._k_fill))
        return orig(e, toks, slot, start, tlen, k, width, prefix)
    eng._chunk_call = call


def partings(a: Tokens, b: Tokens) -> Dict[str, int]:
    """{uid: the first token index at which the two transcripts part}."""
    out = {}
    for uid, ta in a.items():
        tb = b[uid]
        diff = [i for i, (x, y) in enumerate(zip(ta, tb)) if x != y]
        if diff or len(ta) != len(tb):
            out[uid] = diff[0] if diff else min(len(ta), len(tb))
    return out


def shared_keys(a: Tokens, b: Tokens) -> List[Tuple[str, int]]:
    """(uid, i) of every token both runs read from the same context: each
    request's tokens up to and including the one where they part."""
    parts = partings(a, b)
    return [(uid, i) for uid, ta in a.items()
            for i in range(min(len(ta), len(b[uid]), parts.get(uid, 1 << 30)
                               + 1))]


def compare(tok_a: Tokens, rows_a: Rows, tok_b: Tokens, rows_b: Rows,
            row_tol: float, tol: float = LOGIT_TOL) -> dict:
    """Run ``b`` against run ``a`` (the baseline): the partings with their
    readings, the largest whole-row difference over the shared tokens, and
    ``ok``, whether both hold (module docstring)."""
    ties = []
    for uid, i in sorted(partings(tok_a, tok_b).items()):
        a, b = rows_a[(uid, i)], rows_b[(uid, i)]
        chosen = [tok_a[uid][i], tok_b[uid][i]]
        la, lb = a[chosen].tolist(), b[chosen].tolist()
        top = torch.topk(a, 2).values
        ties.append({"uid": uid, "token": i, "chosen": chosen,
                     "logits_a": la, "logits_b": lb,
                     "gap": max(abs(x - y) for x, y in zip(la, lb)),
                     "top2_margin": float(top[0] - top[1]),
                     "choice_margin": la[0] - la[1]})
    keys = shared_keys(tok_a, tok_b)
    worst = {"gap": 0.0, "at": None, "vocab": None, "logit": None}
    gaps = []
    for key in keys:
        diff = (rows_a[key] - rows_b[key]).abs()
        j = int(diff.argmax())
        gaps.append(float(diff[j]))
        if gaps[-1] > worst["gap"]:
            worst = {"gap": gaps[-1], "at": list(key), "vocab": j,
                     "logit": float(rows_a[key][j])}
    gaps.sort()
    ok_ties = all(t["gap"] <= tol and max(t["top2_margin"],
                                          t["choice_margin"]) < tol
                  for t in ties)
    return {"partings": ties, "rows": len(keys), "row_max": worst,
            "rows_equal": sum(g == 0.0 for g in gaps),
            "row_median": gaps[len(gaps) // 2] if gaps else 0.0,
            "row_tol": row_tol, "ok_ties": ok_ties,
            "ok_rows": worst["gap"] <= row_tol,
            "ok": ok_ties and worst["gap"] <= row_tol}


def describe(c: dict) -> str:
    """One line of :func:`compare`'s readings."""
    w = c["row_max"]
    head = (f"{len(c['partings'])} parting(s); whole rows over {c['rows']} "
            f"shared tokens ({c['rows_equal']} equal bit for bit): largest "
            f"difference {w['gap']:.4g} (at "
            f"{w['at']}, vocab {w['vocab']}, logit "
            + (f"{w['logit']:.4g}" if w["logit"] is not None else "-")
            + f"), median {c['row_median']:.4g}, limit {c['row_tol']}")
    ties = "; ".join(
        f"{t['uid']} token {t['token']}: chose {t['chosen']}, logits "
        f"{t['logits_a']} vs {t['logits_b']} (gap {t['gap']:.4g}), "
        f"top-two margin {t['top2_margin']:.4g}, between the choices "
        f"{t['choice_margin']:.4g}" for t in c["partings"])
    return head + (f"; {ties}" if ties else "")
