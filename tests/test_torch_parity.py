"""``repro_torch.benchmarks.parity``: the bf16 near-tie gate that holds two
serve engines' transcripts against each other (``chip_smoke.py``'s
``sharded`` phase, ``bench_sharded_serve`` on the card).  Synthetic
transcripts and logits rows, so each verdict is known."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks.parity import (LOGIT_TOL, compare,  # noqa: E402
                                           describe, partings, record_logits,
                                           shared_keys)

V = 16


def _rows(tokens, seed, noise=0.0):
    """A logits row for every token: the chosen token well ahead of the
    rest, plus ``noise`` drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    rows = {}
    for uid, toks in tokens.items():
        for i, t in enumerate(toks):
            r = torch.linspace(-2.0, 1.0, V)
            r[t] = 4.0
            rows[(uid, i)] = r + noise * torch.randn(V, generator=g)
    return rows


def test_partings_and_shared_keys():
    a = {"x": [1, 2, 3, 4], "y": [5, 6, 7]}
    b = {"x": [1, 2, 9, 4], "y": [5, 6, 7]}
    assert partings(a, b) == {"x": 2}
    assert shared_keys(a, b) == [("x", 0), ("x", 1), ("x", 2),
                                 ("y", 0), ("y", 1), ("y", 2)]
    assert partings(a, {"x": [1, 2], "y": [5, 6, 7]}) == {"x": 2}


def test_equal_runs_pass_and_rounding_stays_within_the_row_limit():
    toks = {"x": [1, 2, 3], "y": [4, 5]}
    c = compare(toks, _rows(toks, 0), toks, _rows(toks, 0, noise=0.01),
                row_tol=0.1)
    assert c["ok"] and not c["partings"] and c["rows"] == 5
    assert 0 < c["row_max"]["gap"] <= 0.1
    assert "0 parting(s)" in describe(c)


def test_a_near_tie_passes_and_a_wrong_row_fails():
    a_tok = {"x": [1, 2, 3]}
    b_tok = {"x": [1, 7, 8]}
    ra, rb = _rows(a_tok, 0), _rows(b_tok, 0)
    # token 1: a chose 2 by one bf16 step over 7; b the other way round
    ra[("x", 1)][7] = 4.0 - 0.03125
    rb[("x", 1)] = ra[("x", 1)].clone()
    rb[("x", 1)][[2, 7]] = torch.tensor([4.0 - 0.03125, 4.0 - 0.03125])
    c = compare(a_tok, ra, b_tok, rb, row_tol=0.1)
    assert [t["token"] for t in c["partings"]] == [1]
    assert c["rows"] == 2 and c["ok"]
    # the same parting with the whole row moved past the limit elsewhere
    rb[("x", 1)][0] += 0.5
    c = compare(a_tok, ra, b_tok, rb, row_tol=0.1)
    assert c["ok_ties"] and not c["ok_rows"] and not c["ok"]
    assert c["row_max"]["at"] == ["x", 1] and c["row_max"]["vocab"] == 0
    # a parting that is no near-tie: a's margin is wide
    ra2 = _rows(a_tok, 0)
    rb2 = dict(ra2)
    rb2[("x", 1)] = ra2[("x", 1)].clone()
    rb2[("x", 1)][7] = 5.0
    c = compare(a_tok, ra2, b_tok, rb2, row_tol=10.0)
    assert not c["ok_ties"] and not c["ok"]
    assert c["partings"][0]["top2_margin"] > LOGIT_TOL


def test_record_logits_keeps_every_fetched_row():
    class Req:
        def __init__(self, uid):
            self.uid = uid

    class Eng:
        def _lane_tokens(self, src, logits, greedy, picks):
            return [int(greedy[lane]) for lane, _, _ in picks]
    eng, rows = Eng(), {}
    record_logits(eng, rows)
    logits = torch.arange(2 * V, dtype=torch.bfloat16).reshape(2, V)
    got = eng._lane_tokens("decode", logits, torch.tensor([3, 5]),
                           [(1, Req("x"), 0), (0, Req("y"), 4)])
    assert got == [5, 3]
    assert set(rows) == {("x", 0), ("y", 4)}
    assert rows[("x", 0)].dtype == torch.float32
    assert torch.equal(rows[("y", 4)], logits[0].float())
