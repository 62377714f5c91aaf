"""Device-semantics parity: the XLA scan engine vs the oracle.

Every tier and every scan mode must agree with the oracle bit-for-bit on
fullmatch, ends bitmaps, and starts bitmaps (SURVEY.md SS4.2's conformance
bar)."""
import random

import numpy as np
import pytest

from roaringregex.compiler.program import compile_program
from roaringregex.oracle.engine import OracleEngine
from roaringregex.ops import scan_xla as sx


def _batchify(texts, L=None):
    L = L or max((len(t) for t in texts), default=0)
    B = len(texts)
    data = np.zeros((B, L), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    for i, t in enumerate(texts):
        b = t.encode()
        data[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    return data, lengths


def _setup(pattern, texts, L=None):
    prog = compile_program(pattern)
    eng = OracleEngine(prog.nfa)
    tables = sx.device_tables(prog)
    data, lengths = _batchify(texts, L)
    cls = sx.encode_stream(
        tables, data, lengths, prog.bos_class, prog.eos_class, prog.dead_class
    )
    return prog, eng, tables, cls, lengths


PATTERNS = [
    "abc",
    "ab|cd",
    "(a|b)(c|d)",
    "a*",
    "(ab)*c+d?",
    "a+b",
    "[a-c]x?",
    "a\\.b",
    "^abc$",
    "abc$",
    "^abc",
    "(a|^b)c",
    "cat|dog",
    ".*e.*",
    "a{2,4}",
    "a{0,2}b",
]

TEXTS = ["", "a", "abc", "abcx", "xabc", "aa", "aaab", "cd", "ab", "ba",
         "catdog", "the dog", "a.b", "axb", "bc", "ac", "ccd", "ababccd",
         "hello", "aeiou", "aaaa", "b"]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_fullmatch_parity(pattern):
    prog, eng, tables, cls, lengths = _setup(pattern, TEXTS)
    flags = np.asarray(
        sx.forward_flags(tables, cls, seeded=False, n_seed_steps=2)
    )
    T1 = flags.shape[1]
    e = np.asarray(sx.end_positions(T1, lengths))
    for i, text in enumerate(TEXTS):
        n = lengths[i]
        # fullmatch: any accepting step whose end == len and which consumed
        # all real bytes (t-1 >= n, or n == 0)
        t = np.arange(T1)
        covers = (np.maximum(t - 1, 0) >= n) | (n == 0)
        got = bool((flags[i] & (e[i] == n) & covers).any())
        assert got == eng.fullmatch(text), (pattern, text)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_ends_bitmap_parity(pattern):
    prog, eng, tables, cls, lengths = _setup(pattern, TEXTS)
    flags = sx.forward_flags(tables, cls, seeded=True)
    L = max(len(t) for t in TEXTS)
    bm = np.asarray(
        sx.ends_bitmap(flags, lengths, L, prog.nullable, seeded=True)
    )
    for i, text in enumerate(TEXTS):
        want = eng.ends(text)
        got = {int(p) for p in np.nonzero(bm[i])[0] if p <= lengths[i]}
        assert got == want, (pattern, text, got, want)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_starts_bitmap_parity(pattern):
    prog, eng, tables, cls, lengths = _setup(pattern, TEXTS)
    hits = sx.reverse_hits(tables, cls, seed_accept=True)
    L = max(len(t) for t in TEXTS)
    bm = np.asarray(sx.starts_bitmap(hits, lengths, L, prog.nullable))
    for i, text in enumerate(TEXTS):
        want = eng.starts(text)
        got = {int(p) for p in np.nonzero(bm[i])[0] if p <= lengths[i]}
        assert got == want, (pattern, text, got, want)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_match_stats_parity(pattern):
    prog, eng, tables, cls, lengths = _setup(pattern, TEXTS)
    cnt, first, anym = (
        np.asarray(x)
        for x in sx.match_stats(
            tables, cls, lengths, seeded=True, nullable=prog.nullable
        )
    )
    for i, text in enumerate(TEXTS):
        want_ends = eng.ends(text)
        assert cnt[i] == len(want_ends), (pattern, text, cnt[i], want_ends)
        assert bool(anym[i]) == bool(want_ends)
        if want_ends:
            assert first[i] == min(want_ends), (pattern, text)


def test_sparse_tier_parity():
    """a{1,300}-class patterns (block-sparse follow) via the XLA dense
    fallback: parity on tier-crossing lengths."""
    texts = ["a" * k for k in (0, 1, 5, 299, 300, 301)]
    prog, eng, tables, cls, lengths = _setup("a{1,300}", texts)
    assert prog.tier == "multiblock"
    cnt, first, anym = sx.match_stats(
        tables, cls, lengths, seeded=True, nullable=prog.nullable
    )
    for i, text in enumerate(texts):
        assert int(cnt[i]) == len(eng.ends(text)), text


def test_fuzz_parity_random_patterns():
    rng = random.Random(99)
    from tests.test_oracle_conformance import _gen_pattern

    for _ in range(25):
        pattern = _gen_pattern(rng)
        texts = [
            "".join(rng.choice("abcd") for _ in range(rng.randint(0, 10)))
            for _ in range(8)
        ]
        prog, eng, tables, cls, lengths = _setup(pattern, texts, L=10)
        flags = sx.forward_flags(tables, cls, seeded=True)
        L = 10
        bm = np.asarray(
            sx.ends_bitmap(flags, lengths, L, prog.nullable, seeded=True)
        )
        hits = sx.reverse_hits(tables, cls)
        sbm = np.asarray(sx.starts_bitmap(hits, lengths, L, prog.nullable))
        for i, text in enumerate(texts):
            got_e = {int(p) for p in np.nonzero(bm[i])[0] if p <= lengths[i]}
            got_s = {int(p) for p in np.nonzero(sbm[i])[0] if p <= lengths[i]}
            assert got_e == eng.ends(text), (pattern, text)
            assert got_s == eng.starts(text), (pattern, text)
