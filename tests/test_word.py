"""Word kernel (ops/scan_word.py, Pallas-Triton; interpret mode on CPU).

The word path gives each record a full 32-bit state set (9..32-state
programs, multi-pattern accept channels); every match_stats_b output must
agree exactly with the oracle, and the wrapper must handle any batch
shape: B not a multiple of the record block, L not a multiple of the
4-byte word, empty records, anchors and accept channels.
"""
import numpy as np
import pytest

from roaringregex import platform
from roaringregex.compiler.program import compile_program
from roaringregex.engine import ScanEngine
from roaringregex.ops import scan_word as ssw32
from roaringregex.ops.scan_word import BLK, WordScanner
from roaringregex.oracle.engine import OracleEngine

from oracle_stats import assert_stats_match_oracle

# 9..32-state patterns (s_tile 16/32) plus a couple of 8-state ones (the
# word path must be correct there too, even though the engine prefers the
# 4-records-per-u32 tier)
PATTERNS = [
    "(ab|cd)+e{2,3}fgh",
    "abcdefghij",  # 11 states, literal chain
    "[a-f]{2,6}z",
    "(cat|dog|bird)+",
    "a{10,20}",
    "^[a-z]{3,8}[.]log$",  # anchors + classes
    "(ab)*c+d?",  # 8-state
    "x(yz|zy)*x$",  # EOS
    "a*b*c*d*e*",  # nullable wide
]


def _batch(seed=0, n=60, maxlen=40, L=48, G=16):
    rng = np.random.default_rng(seed)
    texts = [
        b"", b"cat", b"catdogbird", b"ababccd", b"abcdefghij", b"xyzyx",
        b"aaaaaaaaaaaa", b"abc.log", b"ffz",
    ]
    for _ in range(n):
        ln = int(rng.integers(0, maxlen))
        texts.append(
            bytes(
                rng.choice(list(b"abcdefghijz.xylog"), size=ln).astype(
                    np.uint8
                )
            )
        )
    Bp = ((len(texts) + G - 1) // G) * G
    data = np.zeros((Bp, L), np.uint8)
    lengths = np.zeros(Bp, np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    return data, lengths


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seeded", [True, False])
def test_match_stats_parity(pattern, seeded):
    prog = compile_program(pattern)
    spec = ssw32.word_spec(prog)
    assert spec is not None, f"{pattern} should fit s_tile<=32"
    sw = WordScanner(prog)
    data, lengths = _batch(G=prog.G)
    out = sw.match_stats_b(data, lengths.reshape(-1, prog.G), seeded=seeded)
    assert_stats_match_oracle(prog, out, data, lengths, seeded, pattern)


def test_spec_rejects_wide():
    assert ssw32.word_spec(compile_program("a{1,300}")) is None


def test_engine_selects_word_tier():
    eng = ScanEngine(
        compile_program("(ab|cd)+e{2,3}fgh"), backend="pallas"
    )
    assert isinstance(eng.device_scanner, WordScanner)
    # 8-state single patterns take the same word kernel on the GPU route
    eng8 = ScanEngine(compile_program("cat|dog"), backend="pallas")
    assert isinstance(eng8.device_scanner, WordScanner)
    prog = compile_program("(ab|cd)+e{2,3}fgh")
    assert platform.route(prog, plat="gpu").kernel == "word"
    assert platform.route(prog, plat="cpu").kernel is None


def test_multipattern_finditer_combined_scan():
    """finditer_batch matches per-pattern extraction exactly, nullable
    channels included, while count_batch runs ONE combined word scan."""
    from roaringregex.api import MultiPattern, Pattern

    pats = ["cat|dog", "[0-9]{3}", "(er)*", "ab(cd)*e"]  # one nullable
    mp = MultiPattern(pats, backend="pallas")
    assert mp.engine.route.kernel == "word" and mp.engine.P == 4
    texts = [
        b"the cat sat on a dog", b"error 4041 erer", b"abcdcdcde abe",
        b"", b"x" * 25, b"cat999dogerer", b"abe abcde", b"dogcat",
    ]
    got = mp.finditer_batch(texts)
    for p, pat in enumerate(pats):
        want = Pattern(pat, backend="pallas").finditer_batch(texts)
        assert got[p] == want, pat


def test_multipattern_finditer_greedy_fallback():
    from roaringregex.api import MultiPattern, Pattern

    pats = ["cat|dog", "[0-9]{3}"]
    mp = MultiPattern(pats, backend="pallas")
    texts = [b"cat99 dog123", b"", b"9999"]
    got = mp.finditer_batch(texts, longest=True)
    for p, pat in enumerate(pats):
        want = Pattern(pat, backend="pallas").finditer_batch(
            texts, longest=True
        )
        assert got[p] == want, pat


def test_multipattern_channels_parity():
    """MultiPattern through the engine (WordScanner accept channels) vs
    per-pattern single scans."""
    from roaringregex.api import MultiPattern, Pattern

    # the combined automaton's accept channels ride the word kernel
    pats = ["cat|dog", "[0-9]{3}", "deadbeefs|x", "ab(cd)*e"]
    mp = MultiPattern(pats, backend="pallas")
    assert isinstance(mp.engine.device_scanner, WordScanner)
    texts = [
        b"the cat sat", b"deadbeefs 404", b"abcdcde", b"x" * 30, b"",
        b"dog deadbeefs 123", b"abe", b"catdog999",
    ]
    got = mp.count_batch(texts)
    for p, pat in enumerate(pats):
        want = Pattern(pat).count_batch(texts)
        np.testing.assert_array_equal(got[:, p], want, err_msg=pat)


def test_word_zero_byte_class_no_bos_phantom():
    """Classes containing byte 0 ([^a], .) must not match at the BOS
    step, before the record's first byte."""
    from roaringregex.api import Pattern
    from roaringregex.oracle.engine import OracleEngine

    for pat in [
        "[^a]{1,3}|[ab]a{2}a?(a|bc)|0{2}(a|b)",
        ".[ab]x|q{2}[cd]y{2}z",  # leading-dot, word tier
    ]:
        p = Pattern(pat, backend="pallas")
        assert type(p.engine.device_scanner).__name__ == "WordScanner", pat
        orc = OracleEngine(p.program.nfa)
        texts = [b"", b"a", b"ab", b".abx", b"qqcyyz", b"\x00ab"]
        got = [int(x) for x in p.count_batch(texts)]
        want = [len(orc.ends(t)) for t in texts]
        assert got == want, (pat, got, want)


# ---------------------------------------------------------------------------
# Wrapper shapes: blocks, word padding, empty records, anchors, channels
# ---------------------------------------------------------------------------


def _records(texts, L):
    data = np.zeros((len(texts), L), np.uint8)
    lengths = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    return data, lengths


def test_word_batch_not_multiple_of_block():
    """B spans two record blocks plus a ragged tail (padded internally)."""
    prog = compile_program("cat|dog")
    rng = np.random.default_rng(31)
    B = 2 * BLK + 37
    texts = [
        rng.choice(list(b"catdogx"), int(rng.integers(0, 20)))
        .astype(np.uint8).tobytes()
        for _ in range(B)
    ]
    data, lengths = _records(texts, 20)
    out = WordScanner(prog).match_stats_b(
        data, lengths.reshape(-1, 1), seeded=True
    )
    assert np.asarray(out[0]).shape == (B, 1)
    assert_stats_match_oracle(prog, out, data, lengths, True, "blocks")


@pytest.mark.parametrize("L", [1, 5, 6, 7, 9])
def test_word_length_not_multiple_of_word(L):
    """Record widths that are not a multiple of the 4-byte word, with
    full-length records whose EOS step lands in the padding."""
    prog = compile_program("ab$|b")
    texts = [b"ab"[:L], (b"x" * L)[: L - 2] + b"ab"[: min(L, 2)], b"", b"b" * L]
    data, lengths = _records([t[:L] for t in texts], L)
    for seeded in (True, False):
        out = WordScanner(prog).match_stats_b(
            data, lengths.reshape(-1, 1), seeded=seeded
        )
        assert_stats_match_oracle(prog, out, data, lengths, seeded, L)


def test_word_zero_length_records():
    """Empty records: only BOS/EOS steps run; nullable and anchored
    programs must still report their empty match."""
    for pat in ["a*", "^$", "a|b", "(^|x)y?"]:
        prog = compile_program(pat)
        data, lengths = _records([b""] * 5 + [b"a"], 8)
        for seeded in (True, False):
            out = WordScanner(prog).match_stats_b(
                data, lengths.reshape(-1, 1), seeded=seeded
            )
            assert_stats_match_oracle(prog, out, data, lengths, seeded, pat)


@pytest.mark.parametrize("pattern", ["^abc", "abc$", "^a(b|c)*$", "(^a|b$)"])
def test_word_bos_eos_anchors(pattern):
    """^ fires only at the record start and $ only at its end, also for
    records padded to the batch width."""
    prog = compile_program(pattern)
    texts = [b"abc", b"xabc", b"abcx", b"a", b"ab", b"b", b"acbcb", b""]
    data, lengths = _records(texts, 11)
    for seeded in (True, False):
        out = WordScanner(prog).match_stats_b(
            data, lengths.reshape(-1, 1), seeded=seeded
        )
        assert_stats_match_oracle(prog, out, data, lengths, seeded, pattern)


def test_word_multi_channel_accept():
    """Per-channel accept masks of a combined automaton: channel p counts
    pattern p's ends, exactly as a single-pattern scan would."""
    from roaringregex.api import MultiPattern

    pats = ["cat|dog", "[0-9]{3}", "x$", "^ab"]
    mp = MultiPattern(pats, backend="pallas")
    sc = mp.engine.device_scanner
    assert isinstance(sc, WordScanner) and len(sc.wspec.acc_masks) == 4
    texts = [b"cat 123", b"abx", b"dog9999x", b"", b"ab cat"]
    got = mp.count_batch(texts)
    for p, pat in enumerate(pats):
        orc = OracleEngine.compile(pat)
        assert [int(c) for c in got[:, p]] == [
            len(orc.ends(t)) for t in texts
        ], pat


@pytest.mark.gpu
def test_word_kernel_compiles_on_gpu(gpu):
    """On the card the kernel is compiled (never interpreted) and agrees
    with the packed engine."""
    assert not platform.interpret()
    prog = compile_program("[a-z]+\\.log$")
    rng = np.random.default_rng(2)
    data = rng.choice(
        np.frombuffer(b"abz.log", np.uint8), size=(4 * BLK + 16, 77)
    ).astype(np.uint8)  # not a multiple of the record block
    lengths = rng.integers(0, 78, size=data.shape[0]).astype(np.int32)
    eng = ScanEngine(prog, backend="pallas")
    ref = ScanEngine(prog, backend="packed")
    assert isinstance(eng.device_scanner, WordScanner)
    for seeded in (True, False):
        a = eng.match_stats(data, lengths, seeded=seeded)
        b = ref.match_stats(data, lengths, seeded=seeded)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
