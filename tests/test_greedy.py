"""Greedy (leftmost-longest, POSIX) span policy: oracle + device parity.

The reference *declares* a greedy iterator and admits it was never made
greedy (/root/reference/README.md:55 "Greedy iterater not greedy";
scaffolding at src/inc/regex.h:150-165). Here the policy is implemented
for real: per start, the *last* accepting end of the anchored scan.

Note POSIX leftmost-longest differs from Python re's backtracking-greedy
on alternations (``a|ab`` on "ab": POSIX -> "ab", re -> "a"), so the re
cross-check below restricts to patterns where the two agree.
"""
import re

import numpy as np
import pytest

from roaringregex.api import Pattern
from roaringregex.oracle.engine import OracleEngine

# patterns where Python re's greedy == POSIX leftmost-longest
RE_SAFE = [
    "a+",
    "(ab)+",
    "a{2,6}",
    "[a-c]+",
    "ab*c?",
    "x[0-9]*",
]

TEXTS = [
    b"",
    b"a",
    b"aaaa",
    b"abababab",
    b"aabbaacc",
    b"xx12x345yx",
    b"abcabcabc",
    b"cacbcc",
]


@pytest.mark.parametrize("pattern", RE_SAFE)
def test_greedy_matches_re(pattern):
    p = Pattern(pattern)
    rx = re.compile(pattern.encode())
    for t in TEXTS:
        got = p.finditer_batch([t], longest=True)[0]
        want = [m.span() for m in rx.finditer(t)]
        assert got == want, (pattern, t, got, want)


# POSIX-longest-specific cases (re disagrees -- oracle is normative)
@pytest.mark.parametrize(
    "pattern,text,want",
    [
        ("a|ab", b"ab", [(0, 2)]),  # POSIX picks the longer alternative
        ("a|ab", b"aab", [(0, 1), (1, 3)]),
        ("x|xy|xyz", b"xyzxy", [(0, 3), (3, 5)]),
    ],
)
def test_posix_longest_alternation(pattern, text, want):
    p = Pattern(pattern)
    assert p.finditer_batch([text], longest=True)[0] == want
    assert list(OracleEngine(p.program.nfa).finditer(text, longest=True)) == want


@pytest.mark.parametrize(
    "pattern",
    ["a*", "(cat|dog)*", "a|ab", "(ab)*c+d?", "a{0,3}b?", "^a+", "a+$"],
)
def test_greedy_device_vs_oracle(pattern):
    """Differential: device greedy spans == oracle greedy spans."""
    p = Pattern(pattern)
    o = OracleEngine(p.program.nfa)
    rng = np.random.default_rng(7)
    texts = list(TEXTS)
    for _ in range(30):
        ln = int(rng.integers(0, 24))
        texts.append(
            bytes(rng.choice(list(b"abcdxy"), size=ln).astype(np.uint8))
        )
    got = p.finditer_batch(texts, longest=True)
    for t, g in zip(texts, got):
        want = list(o.finditer(t, longest=True))
        assert g == want, (pattern, t, g, want)


def test_lazy_vs_greedy_differ():
    p = Pattern("a+")
    assert p.finditer_batch([b"aaa"], longest=False)[0] == [
        (0, 1), (1, 2), (2, 3)
    ]
    assert p.finditer_batch([b"aaa"], longest=True)[0] == [(0, 3)]
    m = list(p.finditer(b"aaa", longest=True))
    assert [x.span() for x in m] == [(0, 3)]
    assert p.findall(b"aaa", longest=True) == [b"aaa"]


def test_greedy_swar_kernels_engaged():
    """Small-automaton patterns on the ``pallas`` route: match stats on
    the word kernel, greedy spans as one device program (engine.spans)
    and anchored rescans on the packed engine, with oracle parity."""
    import numpy as np

    from roaringregex.api import Pattern
    from roaringregex.oracle.engine import OracleEngine
    from roaringregex.ops.scan_word import WordScanner

    p = Pattern("a+b?", backend="pallas")
    assert isinstance(p.engine.device_scanner, WordScanner)
    assert p.engine.device_spans
    orc = OracleEngine(p.program.nfa)
    rng = np.random.default_rng(9)
    texts = ["aaab", "abab", "ba", "", "a" * 50 + "b"]
    for _ in range(8):
        ln = int(rng.integers(0, 120))
        texts.append("".join(rng.choice(list("aab b"), size=ln)))
    got = p.finditer_batch(texts, longest=True)
    for t, spans in zip(texts, got):
        assert spans == orc.findall(t, longest=True), repr(t)
    # anchored rescan parity, lazy + longest, via engine.first_end_from
    G = max(1, p.program.G)
    data = np.zeros((2 * G, 16), np.uint8)
    lens = np.zeros(2 * G, np.int32)
    sts = np.zeros(2 * G, np.int32)
    cases = [("aaab", 0), ("aaab", 1), ("abab", 2), ("b", 0)]
    for i, (t, s) in enumerate(cases):
        data[i, : len(t)] = np.frombuffer(t.encode(), np.uint8)
        lens[i] = len(t)
        sts[i] = s
    sts[len(cases):] = -1
    for longest in (False, True):
        ends = np.asarray(
            p.engine.first_end_from(data, lens, sts, longest=longest)
        )
        for i, (t, s) in enumerate(cases):
            b = t.encode()
            ref = (
                orc.last_end_from(b, s) if longest
                else orc.first_end_from(b, s)
            )
            ref = -1 if ref is None else ref
            assert int(ends[i]) == ref, (t, s, longest, int(ends[i]), ref)
