"""Multi-pattern grep: one combined automaton, per-pattern channels."""
import numpy as np
import pytest

import roaringregex as rrx
from roaringregex.oracle.engine import OracleEngine

PATTERN_SETS = [
    ["cat", "dog", "bird"],
    ["cat|dog", "[0-9]+", "(ab)*c"],
    ["a*", "err(or)?", "^x"],          # includes a nullable pattern
    ["[a-f]{3}", "z", "foo$"],
]

TEXTS = ["catdog9", "", "bird", "abc", "ababc x", "zzz", "error!", "xfoo",
         "deadbeef", "a" * 30]


@pytest.mark.parametrize("patterns", PATTERN_SETS)
def test_multi_matches_singletons(patterns):
    mp = rrx.MultiPattern(patterns)
    assert mp._singles is None, "expected the combined fast path"
    oracles = [OracleEngine(rrx.build_nfa(p)) for p in patterns]
    got_cnt = mp.count_batch(TEXTS)
    got_hit = mp.search_batch(TEXTS)
    for i, t in enumerate(TEXTS):
        for p, orc in enumerate(oracles):
            assert got_cnt[i, p] == len(orc.ends(t)), (patterns[p], t)
            assert bool(got_hit[i, p]) == orc.search(t), (patterns[p], t)


def test_multi_sparse_fallback():
    mp = rrx.MultiPattern(["a{2,900}", "b{2,300}"])
    # combined automaton exceeds 1024 states -> per-pattern fallback
    hits = mp.search_batch(["a" * 5, "b" * 5, "ab"])
    assert hits.tolist() == [[True, False], [False, True], [False, False]]


def test_multi_empty_and_errors():
    with pytest.raises(ValueError):
        rrx.MultiPattern([])
    with pytest.raises(rrx.RegexSyntaxError):
        rrx.MultiPattern(["a", "b{3,1}"])


def test_multipattern_sparse_single_pass():
    """Sparse-tier MultiPattern on the pallas route: the unpacked XLA
    engine has one accept channel, so each pattern scans on its own
    route (counting patterns on the run-length scanner); counts stay
    exact per pattern."""
    import numpy as np

    from roaringregex.api import MultiPattern, Pattern
    from roaringregex.oracle.engine import OracleEngine

    pats = ["a{3,1200}", "b{2,4}"]
    mp = MultiPattern(pats, backend="pallas")
    assert mp.program.tier == "sparse"
    assert mp.engine.backend == "xla" and mp._singles is not None
    assert mp._singles[0].engine.route.kernel == "count"
    texts = [b"", b"aaa", b"a" * 50, b"bb", b"bbbbb", b"ab" * 5]
    cnt = mp.count_batch(texts)
    for p, pat in enumerate(pats):
        o = OracleEngine(Pattern(pat).program.nfa)
        for i, t in enumerate(texts):
            assert int(cnt[i, p]) == len(o.ends(t)), (pat, t)


def test_multipattern_no_monkey_patching():
    """The engine owns the accept channels; api must not write private
    engine state."""
    from roaringregex.api import MultiPattern

    mp = MultiPattern(["cat|dog", "ab"], backend="pallas")
    eng = mp.engine
    assert eng.P == 2
    # the program's packing G is untouched; channels live in the word
    # kernel's accept masks and the packed accept map
    assert len(eng.device_scanner.wspec.acc_masks) == 2
    assert eng._ptables["A"].shape[1] == mp.program.G * 2


def test_multipattern_finditer_batch():
    """Per-pattern span extraction: [P][B] lists, both policies, vs the
    oracle (the non-overlap policy is per-pattern; combined-automaton
    channels only accelerate the boolean/count paths)."""
    import roaringregex as rrx
    from roaringregex.oracle.engine import OracleEngine

    mp = rrx.MultiPattern(["cat|dog", "[0-9]+", "ab"])
    texts = [b"a cat 42", b"nothing", b"dog9ab", b""]
    for longest in (False, True):
        out = mp.finditer_batch(texts, longest=longest)
        assert len(out) == mp.P
        for p, patstr in enumerate(mp.patterns):
            orc = OracleEngine.compile(patstr)
            for b, t in enumerate(texts):
                assert out[p][b] == list(orc.finditer(t, longest=longest))


def test_multipattern_swar_slotted():
    """Small patterns run the combined grep scan as ONE word-kernel pass
    with exact per-channel stats — including nullable and $-anchored
    channels."""
    import numpy as np

    from roaringregex.api import MultiPattern
    from roaringregex.compiler.nfa import build_nfa
    from roaringregex.oracle.engine import OracleEngine
    from roaringregex.ops.scan_word import WordScanner

    pats = ["cat|dog", "[0-9]{3}", "err(or)?", "ab(cd)*e"]
    mp = MultiPattern(pats, backend="pallas")
    assert isinstance(mp.engine.device_scanner, WordScanner)
    rng = np.random.default_rng(5)
    texts = ["the cat had 4215 errors", "abcdcde or err", "", "dog" * 40]
    for _ in range(8):
        ln = int(rng.integers(0, 180))
        texts.append(
            "".join(rng.choice(list("catdoger0123 abcde"), size=ln))
        )
    cnt = mp.count_batch(texts)
    for p_i, pat in enumerate(pats):
        orc = OracleEngine(build_nfa(pat))
        for t_i, t in enumerate(texts):
            assert int(cnt[t_i, p_i]) == len(orc.ends(t)), (pat, t_i)
    # fewer than 4 slots + nullable + $-anchor channels
    mp2 = MultiPattern(["a*", "x$"], backend="pallas")
    assert isinstance(mp2.engine.device_scanner, WordScanner)
    c2 = mp2.count_batch(["aaax", "x", "", "bxb"])
    for p_i, pat in enumerate(["a*", "x$"]):
        orc = OracleEngine(build_nfa(pat))
        for t_i, t in enumerate(["aaax", "x", "", "bxb"]):
            assert int(c2[t_i, p_i]) == len(orc.ends(t)), (pat, t)
