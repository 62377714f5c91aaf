"""End-to-end API tests: Pattern/Match vs the oracle spec."""
import numpy as np
import pytest

import roaringregex as rrx
from roaringregex.oracle.engine import OracleEngine

TEXTS = ["", "a", "abc", "xxabyyabz", "aaab", "catdog", "the dog barks",
         "ba", "abab", "a.b", "ccd", "hello world", "aaaa"]


@pytest.fixture(scope="module", params=["abc", "ab", "a+", "cat|dog", "a*",
                                        "^ab", "ab$", "(ab)*c+d?", "a{2,4}"])
def pat(request):
    return rrx.compile(request.param)


def test_fullmatch_batch_matches_oracle(pat):
    eng = OracleEngine(pat.program.nfa)
    got = pat.fullmatch_batch(TEXTS)
    for t, g in zip(TEXTS, got):
        assert bool(g) == eng.fullmatch(t), (pat.pattern, t)


def test_search_batch_matches_oracle(pat):
    eng = OracleEngine(pat.program.nfa)
    got = pat.search_batch(TEXTS)
    for t, g in zip(TEXTS, got):
        assert bool(g) == eng.search(t), (pat.pattern, t)


def test_count_batch_matches_oracle(pat):
    eng = OracleEngine(pat.program.nfa)
    got = pat.count_batch(TEXTS)
    for t, g in zip(TEXTS, got):
        assert int(g) == len(eng.ends(t)), (pat.pattern, t)


def test_finditer_batch_matches_oracle(pat):
    eng = OracleEngine(pat.program.nfa)
    got = pat.finditer_batch(TEXTS)
    for t, spans in zip(TEXTS, got):
        assert spans == eng.findall(t), (pat.pattern, t, spans, eng.findall(t))


def test_single_string_api():
    p = rrx.compile("cat|dog")
    m = p.search("hot dog stand")
    assert m and m.span() == (4, 7) and m.group() == b"dog"
    assert p.fullmatch("cat")
    assert not p.fullmatch("cats")
    assert [m.span() for m in p.finditer("catdog")] == [(0, 3), (3, 6)]
    assert p.findall("catdog") == [b"cat", b"dog"]
    assert p.match("catalog").span() == (0, 3)
    assert p.match("dot") is None


def test_grep():
    p = rrx.compile("error|warn")
    lines = ["ok", "error: disk full", "fine", "warning: hot", "done"]
    assert p.grep(lines) == [1, 3]


def test_introspection():
    p = rrx.compile("(a|b)c")
    assert p.n_states == 4
    assert p.tier == "dense128"
    assert "follow=" in p.dump()


def test_tier_routing():
    assert rrx.compile("abc").tier == "dense128"
    assert rrx.compile("a" * 200).tier == "dense256"
    assert rrx.compile("a{1,300}").tier == "multiblock"
    assert rrx.compile("a{1,1100}").tier == "sparse"


def test_long_record():
    """Records longer than one padding bucket still match correctly."""
    p = rrx.compile("needle")
    hay = "x" * 5000 + "needle" + "y" * 3000
    assert p.finditer_batch([hay])[0] == [(5000, 5006)]
    assert p.count_batch([hay])[0] == 1
