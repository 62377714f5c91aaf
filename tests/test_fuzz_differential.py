"""Differential fuzz: random patterns x random texts, all engines vs oracle.

The broad safety net on top of the per-tier parity suites: generates
syntactically valid patterns across the feature grid (SURVEY.md §7.4),
compiles through the production path (native compiler when built), and
checks fullmatch / search / count / spans for every backend against the
oracle, plus Python ``re`` on the shared-semantics subset.
"""
import re

import numpy as np
import pytest

import roaringregex as rrx
from roaringregex.oracle.engine import OracleEngine

ATOMS = ["a", "b", "c", "x", "0", ".", "[ab]", "[a-c]", "[^a]", "(ab)",
         "(a|b)", "\\.", "(a|bc)"]
QUANTS = ["", "", "*", "+", "?", "{2}", "{1,3}", "{0,2}", "{2,}"]


def _gen_pattern(rng) -> str:
    n = int(rng.integers(1, 5))
    parts = []
    for _ in range(n):
        a = ATOMS[int(rng.integers(0, len(ATOMS)))]
        q = QUANTS[int(rng.integers(0, len(QUANTS)))]
        parts.append(a + q)
    pat = "".join(parts)
    if rng.random() < 0.3:
        pat = pat + "|" + _gen_pattern(rng) if pat else pat
    if rng.random() < 0.15:
        pat = "^" + pat
    if rng.random() < 0.15:
        pat = pat + "$"
    return pat


def _gen_texts(rng, n=10):
    out = [b"", b"a", b"ab", b"abc"]
    for _ in range(n):
        ln = int(rng.integers(0, 14))
        out.append(bytes(rng.choice(list(b"abcx0."), size=ln).astype(np.uint8)))
    return out


def _gen_blowup_pattern(rng) -> str:
    """Big-automaton repetition families: counting-tier alternation
    bodies, seeded-alias whole-pattern blowups, dotstar wrappers — the
    round-4 rewrite tiers."""
    bodies = ["a", "[ab]", "ab", "(ab|cd)", "(a|b)", "(abc|xbc)",
              "(ab|c)", "(abc|de)"]
    body = bodies[int(rng.integers(0, len(bodies)))]
    m = int(rng.integers(0, 4))
    n = int(rng.integers(m + 1, 60))
    pat = f"{body}{{{m},{n}}}"
    roll = rng.random()
    if roll < 0.2:
        pat = ".*" + pat
    elif roll < 0.35:
        pat = pat + ".*"
    elif roll < 0.45:
        pat = "x" + pat  # context blocks the seeded alias
    return pat


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_blowup_tiers_vs_oracle(seed):
    """Fuzz the rewrite tiers (counting branches / seeded alias / dotstar
    gating) through the public API against the oracle."""
    rng = np.random.default_rng(1000 + seed)
    tested = 0
    while tested < 12:
        pattern = _gen_blowup_pattern(rng)
        try:
            pat = rrx.Pattern(pattern)
        except rrx.RegexSyntaxError:
            continue
        tested += 1
        orc = OracleEngine(pat.program.nfa)
        texts = [b"", b"ab", b"abcd" * 10, b"x" + b"ab" * 20]
        for _ in range(6):
            ln = int(rng.integers(0, 120))
            texts.append(
                bytes(rng.choice(list(b"abcdex"), size=ln).astype(np.uint8))
            )
        cnt = pat.count_batch(texts)
        sr = pat.search_batch(texts)
        fm = pat.fullmatch_batch(texts)
        for i, t in enumerate(texts):
            ends = orc.ends(t)
            assert int(cnt[i]) == len(ends), (pattern, t)
            assert bool(sr[i]) == bool(ends), (pattern, t)
            assert bool(fm[i]) == orc.fullmatch(t), (pattern, t)
        spans = pat.finditer_batch(texts[:6])
        for t, sp in zip(texts[:6], spans):
            assert sp == list(orc.finditer(t)), (pattern, t)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_engines_vs_oracle(seed):
    rng = np.random.default_rng(seed)
    tested = 0
    while tested < 25:
        pattern = _gen_pattern(rng)
        try:
            pat = rrx.Pattern(pattern)
        except rrx.RegexSyntaxError:
            continue
        tested += 1
        orc = OracleEngine(pat.program.nfa)
        texts = _gen_texts(rng)
        fm = pat.fullmatch_batch(texts)
        sr = pat.search_batch(texts)
        cnt = pat.count_batch(texts)
        spans = pat.finditer_batch(texts)
        for t, f, s, c, sp in zip(texts, fm, sr, cnt, spans):
            assert bool(f) == orc.fullmatch(t), (pattern, t)
            assert bool(s) == orc.search(t), (pattern, t)
            assert int(c) == len(orc.ends(t)), (pattern, t)
            assert sp == orc.findall(t), (pattern, t)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_oracle_vs_re_fullmatch(seed):
    """Oracle fullmatch == re.fullmatch on anchor-free patterns (the
    shared-semantics subset; SURVEY.md §4.2)."""
    rng = np.random.default_rng(100 + seed)
    tested = 0
    while tested < 30:
        pattern = _gen_pattern(rng).replace("^", "").replace("$", "")
        if not pattern or "|" == pattern[0] or pattern[-1] == "|" or "||" in pattern:
            continue
        try:
            orc = OracleEngine(rrx.build_nfa(pattern))
            cre = re.compile(pattern.encode())
        except Exception:
            continue
        tested += 1
        for t in _gen_texts(rng):
            # '.' matches any byte in re but only ASCII<128 here; texts are
            # ASCII so semantics align
            assert orc.fullmatch(t) == bool(cre.fullmatch(t)), (pattern, t)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_long_mode_vs_oracle(seed):
    """Long-string mode (whatever scanner make_long_scanner picks —
    counting windows, overlapped windows, or summaries) vs the oracle on
    random patterns over strings long enough to cross window boundaries."""
    from roaringregex.utils.config import get_config, set_config

    rng = np.random.default_rng(100 + seed)
    base = get_config()
    tested = 0
    try:
        set_config(base.with_(long_block=256))
        while tested < 8:
            pattern = _gen_pattern(rng)
            try:
                pat = rrx.Pattern(pattern)
            except rrx.RegexSyntaxError:
                continue
            tested += 1
            orc = OracleEngine(pat.program.nfa)
            for _ in range(3):
                ln = int(rng.integers(0, 900))
                t = bytes(
                    rng.choice(list(b"abcx0."), size=ln).astype(np.uint8)
                )
                assert pat.long.count_ends(t) == len(orc.ends(t)), (
                    pattern, type(pat.long).__name__, ln,
                )
                assert pat.long.fullmatch(t) == orc.fullmatch(t), (
                    pattern, ln,
                )
    finally:
        set_config(base)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_bitband_vs_oracle(seed):
    """Fuzz the sparse tier: random {m,n} tails with context (blocking
    alias/counting), forced onto the sparse tier via a low dense_max;
    the raw XLA scan only (no prefilter) vs oracle."""
    from roaringregex.utils.config import get_config, set_config

    rng = np.random.default_rng(4000 + seed)
    base = get_config()
    try:
        set_config(base.with_(
            seeded_alias=False, sparse_prefilter=False, dense_max=256
        ))
        tested = 0
        while tested < 5:
            bodies = ["(ab|c)", "[a-d]", "(ab|cd|e)", "(abc|d)"]
            body = bodies[int(rng.integers(0, len(bodies)))]
            m = int(rng.integers(60, 110))
            n = m + int(rng.integers(3, 30))
            pre = ["x", "", "xy"][int(rng.integers(0, 3))]
            post = ["y", "", "z"][int(rng.integers(0, 3))]
            pattern = f"{pre}{body}{{{m},{n}}}{post}"
            pat = rrx.Pattern(pattern, backend="pallas")
            if pat.tier != "sparse":
                continue
            tested += 1
            orc = OracleEngine(pat.program.nfa)
            texts = [b"", ("x" + "ab" * n + "y").encode()]
            for _ in range(5):
                ln = int(rng.integers(0, 380))
                texts.append(bytes(
                    rng.choice(list(b"abcdexyz"), size=ln).astype(np.uint8)
                ))
            cnt = pat.count_batch(texts)
            fm = pat.fullmatch_batch(texts)
            for i, t in enumerate(texts):
                assert int(cnt[i]) == len(orc.ends(t)), (pattern, i)
                assert bool(fm[i]) == orc.fullmatch(t), (pattern, i)
    finally:
        set_config(base)


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_multipattern_swar(seed):
    """Fuzz the combined multi-pattern scan (random small patterns x
    random pattern counts, word-kernel accept channels) against
    per-pattern oracles."""
    from roaringregex.api import MultiPattern
    from roaringregex.compiler.nfa import build_nfa

    rng = np.random.default_rng(5000 + seed)
    for _ in range(4):
        P = int(rng.integers(2, 5))
        pats = []
        while len(pats) < P:
            p = _gen_pattern(rng)
            try:
                if build_nfa(p).n_states <= 8:
                    pats.append(p)
            except Exception:
                pass
        mp = MultiPattern(pats, backend="pallas")
        texts = [t.decode("latin1") for t in _gen_texts(rng, n=8)]
        cnt = np.asarray(mp.count_batch(texts))
        for p_i, p in enumerate(pats):
            orc = OracleEngine(build_nfa(p))
            for t_i, t in enumerate(texts):
                assert int(cnt[t_i, p_i]) == len(orc.ends(t)), (pats, p, t)


def test_fuzz_cyclic_finditer_long():
    """Randomized cyclic patterns through the reversed-program long-span
    path vs the oracle (lazy only — greedy is claim-sequential and
    covered by the targeted test)."""
    rng = np.random.default_rng(77)
    pats = ["(ab)*c", "a(bc)*d", "(a|bc)+x", ".*(cat|dog).*"]
    for pattern in pats:
        p = rrx.Pattern(pattern)
        if p.program.horizon is not None:
            continue
        orc = OracleEngine(p.program.nfa)
        base = bytes(rng.choice(list(b"abcdx og"), 900).astype(np.uint8))
        text = base[:300] + b"ababc" + base[300:600] + b"catd" + base[600:]
        got = p.finditer_long(text)
        assert got == orc.findall(text), pattern
