"""Native C++ host runtime parity tests (compiler + corpus packer).

The native library (native/rrx_host.cc) must produce *identical* Glushkov
NFAs to the pure-Python compiler — same position numbering, follow edges,
labels, accept set — across the conformance feature grid plus randomized
pattern fuzzing. The packer must reproduce the Python packing layout.
"""
import numpy as np
import pytest

from roaringregex.compiler import native
from roaringregex.compiler.nfa import build_nfa_py
from roaringregex.compiler.parser import RegexSyntaxError

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)

PATTERNS = [
    "", "a", "abc", "ab|cd", "(a|b)(c|d)", "a*", "(ab)*", "a+b", "ab?",
    "a{2}", "a{2,4}", "a{2,}", "a{0,3}", "...", "a.c", "[a-c]", "[^a-c]",
    "[\\]]", "a\\.b", "(ab)*c+d?", "^abc$", "abc$", "^abc", "cat|dog",
    "(cat|dog)+[0-9]*", "[a-z]+\\.log$", ".*error.*", "a{1,300}",
    "((a|b)*c){2,3}", "\\\\", "\\*", "x{0,0}", "(a?)*b",
]


def _assert_same(pattern):
    n_nat = native.build_nfa_native(pattern)
    n_py = build_nfa_py(pattern)
    assert n_nat.n_states == n_py.n_states, pattern
    assert n_nat.nullable == n_py.nullable, pattern
    assert n_nat.labels == n_py.labels, pattern
    assert n_nat.get_follow_sets() == n_py.get_follow_sets(), pattern
    assert n_nat.accept_set == n_py.accept_set, pattern


@pytest.mark.parametrize("pattern", PATTERNS)
def test_native_compiler_parity(pattern):
    _assert_same(pattern)


def test_native_compiler_fuzz_parity():
    rng = np.random.default_rng(7)
    atoms = list("abcxyz09.") + ["[a-f]", "[^x]", "(ab)", "(a|b)", "\\.", "^", "$"]
    quants = ["", "*", "+", "?", "{2}", "{1,3}", "{2,}"]
    for _ in range(300):
        n = int(rng.integers(1, 6))
        parts = []
        for _ in range(n):
            a = atoms[int(rng.integers(0, len(atoms)))]
            q = quants[int(rng.integers(0, len(quants)))]
            parts.append(a + q)
        pattern = "|".join(
            "".join(parts[i::2]) or "x" for i in range(min(2, n))
        )
        try:
            _assert_same(pattern)
        except RegexSyntaxError:
            # both must reject
            with pytest.raises(RegexSyntaxError):
                build_nfa_py(pattern)
            with pytest.raises(RegexSyntaxError):
                native.build_nfa_native(pattern)


@pytest.mark.parametrize(
    "bad", ["a{3,1}", "(", ")", "[a-", "a|", "|a", "*a", "+", "a{", "[]", "[^\x7f-"]
)
def test_native_rejects_like_python(bad):
    with pytest.raises((RegexSyntaxError, Exception)):
        build_nfa_py(bad)
    with pytest.raises(Exception):
        native.build_nfa_native(bad)


def test_native_too_large():
    from roaringregex.compiler.nfa import PatternTooLargeError

    with pytest.raises(PatternTooLargeError):
        native.build_nfa_native("a{1,20000}")


# ---------------------------------------------------------------------------
# Packer
# ---------------------------------------------------------------------------


def test_pack_corpus_matches_python():
    rng = np.random.default_rng(3)
    lines = []
    for _ in range(100):
        ln = int(rng.integers(0, 50))
        lines.append(bytes(rng.integers(97, 123, ln, dtype=np.uint8)))
    buf = b"\n".join(lines) + b"\n"
    d, l, cnt = native.pack_corpus_native(buf, G=16)
    assert cnt == 100
    assert d.shape[0] % 16 == 0 and d.shape[0] >= 100
    for i, line in enumerate(lines):
        assert l[i] == len(line)
        assert bytes(d[i, : len(line)]) == line
        assert not d[i, len(line):].any()
    # padding rows are zero-length
    assert not l[100:].any()


def test_pack_corpus_trailing_and_empty():
    d, l, cnt = native.pack_corpus_native(b"ab\n\nxyz", G=4)  # no trailing \n
    assert cnt == 3
    assert l[:3].tolist() == [2, 0, 3]
    assert bytes(d[2, :3]) == b"xyz"
    d, l, cnt = native.pack_corpus_native(b"", G=4)
    assert cnt == 0 and l.sum() == 0


# ---------------------------------------------------------------------------
# Host scan engine (self-contained CPU matcher, no device runtime)
# ---------------------------------------------------------------------------


def _host_texts():
    return [
        b"", b"a", b"b", b"aa", b"ab", b"abc", b"abcd", b"cat", b"dog",
        b"catdog0", b"aaaa", b"abab", b"xyz", b"a.c", b"axc", b"]",
        b"error.log", b"some error here", b"a" * 40, b"ab" * 17,
    ]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_host_engine_oracle_parity(pattern):
    """HostEngine (native/rrx_host.cc RrxScanner) must agree with the
    oracle on fullmatch, the distinct-ends count, and the first end."""
    from roaringregex.compiler.native import HostEngine
    from roaringregex.oracle.engine import OracleEngine

    he = HostEngine(pattern)
    orc = OracleEngine.compile(pattern)
    for text in _host_texts():
        assert he.fullmatch(text) == orc.fullmatch(text), (pattern, text)
        ends = orc.ends(text)
        assert he.count_ends(text) == len(ends), (pattern, text)
        want_first = min(ends) if ends else -1
        assert he.first_end(text) == want_first, (pattern, text)
        assert he.search(text) == (len(ends) > 0), (pattern, text)


def test_host_engine_fuzz_parity():
    from roaringregex.compiler.native import HostEngine
    from roaringregex.oracle.engine import OracleEngine

    rng = np.random.default_rng(11)
    atoms = list("abcx.") + ["[a-c]", "[^b]", "(ab)", "(a|b)", "^", "$"]
    quants = ["", "*", "+", "?", "{2}", "{1,3}"]
    for _ in range(60):
        n = int(rng.integers(1, 5))
        pattern = "".join(
            atoms[int(rng.integers(0, len(atoms)))]
            + quants[int(rng.integers(0, len(quants)))]
            for _ in range(n)
        )
        try:
            he = HostEngine(pattern)
        except RegexSyntaxError:
            continue
        orc = OracleEngine.compile(pattern)
        for _ in range(6):
            ln = int(rng.integers(0, 12))
            text = bytes(rng.choice(list(b"abcx"), ln).astype(np.uint8))
            assert he.fullmatch(text) == orc.fullmatch(text), (pattern, text)
            ends = orc.ends(text)
            assert he.count_ends(text) == len(ends), (pattern, text)


def test_host_engine_non_ascii_dead():
    from roaringregex.compiler.native import HostEngine

    he = HostEngine("a.c")
    assert not he.fullmatch(b"a\xffc")  # bytes >= 0x80 are dead symbols
    assert he.fullmatch(b"abc")
    assert he.search(b"zz a~c zz")


def test_host_engine_spans_oracle_parity():
    """rrx_spans (backward viability + anchored rescan) must reproduce the
    oracle finditer policy exactly, lazy and greedy."""
    from roaringregex.compiler.native import HostEngine
    from roaringregex.oracle.engine import OracleEngine

    pats = ["cat|dog", "ab*", "a{2,5}", "(ab)+", "^ab", "ab$", "^a*$",
            "a.b", "x?", "(a|b)*c", "^", "$", "[^a]b", "(ab){2,6}", ".*"]
    for pattern in pats:
        he = HostEngine(pattern)
        orc = OracleEngine.compile(pattern)
        for text in _host_texts():
            for longest in (False, True):
                want = list(orc.finditer(text, longest=longest))
                got = he.finditer(text, longest=longest)
                assert got == want, (pattern, longest, text)


def test_host_engine_spans_fuzz():
    from roaringregex.compiler.native import HostEngine
    from roaringregex.oracle.engine import OracleEngine

    rng = np.random.default_rng(23)
    atoms = list("abcx.") + ["[a-c]", "[^b]", "(ab)", "(a|b)", "^", "$"]
    quants = ["", "*", "+", "?", "{2}", "{1,3}"]
    for _ in range(50):
        n = int(rng.integers(1, 5))
        pattern = "".join(
            atoms[int(rng.integers(0, len(atoms)))]
            + quants[int(rng.integers(0, len(quants)))]
            for _ in range(n)
        )
        try:
            he = HostEngine(pattern)
        except RegexSyntaxError:
            continue
        orc = OracleEngine.compile(pattern)
        for _ in range(8):
            ln = int(rng.integers(0, 14))
            text = bytes(rng.choice(list(b"abcx"), ln).astype(np.uint8))
            for longest in (False, True):
                want = list(orc.finditer(text, longest=longest))
                got = he.finditer(text, longest=longest)
                assert got == want, (pattern, longest, text)


def test_host_engine_spans_cap_regrow():
    """Exact total count drives the one-shot capacity regrow (> 64 spans)."""
    from roaringregex.compiler.native import HostEngine

    he = HostEngine("a")
    text = b"a" * 200
    spans = he.finditer(text)
    assert spans == [(i, i + 1) for i in range(200)]


def test_host_grep_lines_oracle_parity():
    """rrx_grep_lines: whole-buffer grep in one native call must agree
    with per-line oracle search, including $-anchored accepts, dead
    bytes, empty lines, and a missing trailing newline."""
    from roaringregex.compiler.native import HostEngine
    from roaringregex.oracle.engine import OracleEngine

    rng = np.random.default_rng(13)
    for pat in ["cat|dog", "^ab", "ab$", "a{2,5}", "x?", "(a|b)*c", "a{100}"]:
        he = HostEngine(pat)
        orc = OracleEngine.compile(pat)
        lines = [
            bytes(rng.choice(list(b"abcatdogx\xff"[:10]),
                             int(rng.integers(0, 40))))
            for _ in range(120)
        ] + [b"", b"cat", b"ab", b"a" * 100, b"a" * 99]
        buf = b"\n".join(lines) + b"\n"
        hits = he.grep_lines(buf)
        assert len(hits) == len(lines)
        for i, ln in enumerate(lines):
            assert bool(hits[i]) == orc.search(ln), (pat, i, ln[:20])
    he = HostEngine("cat")
    assert list(he.grep_lines(b"xcatx\nnope\nendcat")) == [True, False, True]
    assert list(he.grep_lines(b"")) == []


def test_rebuild_and_load_recovers():
    """_rebuild_and_load: the stale-.so escape hatch must produce a fully
    bound, working library (exercises make -B + temp-copy dlopen)."""
    from roaringregex.compiler import native as nat

    if not nat.available():
        pytest.skip("native library unavailable")
    lib = nat._rebuild_and_load()
    assert lib is not None
    # new-API symbols are bound and callable through a fresh handle
    from roaringregex.compiler.native import HostEngine

    he = HostEngine("cat")
    assert he.finditer(b"xcat") == [(1, 4)]


def test_host_engine_128bit_tier_parity():
    """65..128-state patterns run the double-word lazy DFA (the
    reference's 128-bit SIMD tier analog) — full oracle parity."""
    from roaringregex.compiler.native import HostEngine
    from roaringregex.oracle.engine import OracleEngine

    rng = np.random.default_rng(71)
    for p in ["a{100}", "a{65}", "[ab]{70,90}", "(abcd){17,25}",
              "a{64}b{40}"]:
        he = HostEngine(p)
        orc = OracleEngine.compile(p)
        texts = [
            bytes(rng.choice(list(b"ab"), int(rng.integers(0, 260))))
            for _ in range(12)
        ] + [b"a" * 64, b"a" * 65, b"a" * 100, b"a" * 128, b"a" * 129,
             b"ab" * 64, b"abcd" * 25, b""]
        for t in texts:
            ends = orc.ends(t)
            assert he.count_ends(t) == len(ends), (p, len(t))
            assert he.fullmatch(t) == orc.fullmatch(t), (p, len(t))
            for longest in (False, True):
                assert he.finditer(t, longest=longest) == list(
                    orc.finditer(t, longest=longest)
                ), (p, len(t), longest)
