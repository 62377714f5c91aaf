"""Counting-tier tests.

``X{m,n}`` single-class repetitions (the family the reference's broken
Roaring tier targets, Parser.cpp:165-168) run on the run-length
CountScanner (ops/scan_count.py) — one int32 per record instead of a
lanes^2 follow matmul. Long literal chains stay on the packed engine.
Both must match the oracle exactly, including the span fallback paths
(ends/starts bitmaps, finditer).
"""
import numpy as np
import pytest

from roaringregex.api import Pattern
from roaringregex.compiler.program import compile_program
from roaringregex.engine import ScanEngine
from roaringregex.ops.scan_count import CountScanner, counting_plan
from roaringregex.oracle.engine import OracleEngine

COUNTING = ["a{1,300}", "a{3,280}", "[a-c]{2,400}", "a{270,}", "x{0,300}",
            "a{300}", "a{3,1200}",
            # alternation bodies (equal-length branches): the family the
            # VERDICT's sparse-tier example (ab|cd){1,400} belongs to
            "(ab|cd){1,400}", "(ab|cx){2,280}", "(a|b){2,300}",
            "(abc|xbc|bca){1,200}"]


def _pack(texts):
    L = max((len(t) for t in texts), default=1)
    Lp = 1 << max(4, (max(L, 1) - 1).bit_length())
    B = len(texts)
    data = np.zeros((B, Lp), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lens[i] = len(t)
    return data, lens


def _texts(rng, alphabet=b"abcdx", n=24, maxlen=500):
    ts = [
        bytes(rng.choice(list(alphabet), int(rng.integers(0, maxlen))))
        for _ in range(n)
    ]
    ts += [b"a" * 310, b"a" * 300, b"a" * 299, b"", b"a", b"a" * 270]
    return ts


@pytest.mark.parametrize("pattern", COUNTING)
def test_counting_plan_detected(pattern):
    prog = compile_program(pattern)
    assert counting_plan(prog) is not None
    eng = ScanEngine(prog, backend="pallas")
    assert isinstance(eng.device_scanner, CountScanner)


@pytest.mark.parametrize("pattern", ["cat|dog", "(ab)*", "a{2,4}", "a*b{1,300}"])
def test_counting_plan_rejects(pattern):
    prog = compile_program(pattern)
    if prog.tier in ("multiblock", "sparse"):
        assert counting_plan(prog) is None


@pytest.mark.parametrize("pattern", COUNTING)
def test_counting_stats_oracle_parity(pattern):
    prog = compile_program(pattern)
    eng = ScanEngine(prog, backend="pallas")
    orc = OracleEngine.compile(pattern)
    data, lens = _pack(_texts(np.random.default_rng(5)))
    cnt, first, anym = eng.match_stats(data, lens, seeded=True)
    cnt = np.asarray(cnt).reshape(-1)
    first = np.asarray(first).reshape(-1)
    fm = eng.fullmatch_flags(data, lens)
    for i in range(len(lens)):
        t = bytes(data[i, : lens[i]])
        ends = orc.ends(t)
        assert int(cnt[i]) == len(ends), (pattern, i)
        assert int(first[i]) == (min(ends) if ends else -1), (pattern, i)
        assert bool(fm[i]) == orc.fullmatch(t), (pattern, i)


@pytest.mark.parametrize(
    "pattern",
    ["a{2,300}", "a{3,1200}", "x{0,300}", "(ab|cd){1,400}", "(ab|ba){2,200}"],
)
def test_counting_bitmaps_and_spans(pattern):
    pat = Pattern(pattern, backend="pallas")
    assert isinstance(pat.engine.device_scanner, CountScanner)
    orc = OracleEngine.compile(pattern)
    rng = np.random.default_rng(9)
    texts = [
        bytes(rng.choice(list(b"abx"), int(rng.integers(0, 80))))
        for _ in range(10)
    ] + [b"a" * 40, b""]
    data, lens = _pack(texts)
    maxlen = data.shape[1]
    eb = pat.engine.ends_bitmap(data, lens, maxlen)
    sb = pat.engine.starts_bitmap(data, lens, maxlen)
    for i, t in enumerate(texts):
        assert set(np.nonzero(eb[i])[0]) == orc.ends(t), (pattern, i)
        assert set(np.nonzero(sb[i])[0]) == orc.starts(t), (pattern, i)
    for longest in (False, True):
        spans = pat.finditer_batch(texts, longest=longest)
        for t, sp in zip(texts, spans):
            assert list(sp) == list(orc.finditer(t, longest=longest)), (
                pattern, longest, t,
            )


def test_counting_unseeded_flags():
    pat = "a{2,5}"
    # force counting by widening: use a multiblock-size variant instead
    pat = "a{2,300}"
    prog = compile_program(pat)
    eng = ScanEngine(prog, backend="pallas")
    orc = OracleEngine.compile(pat)
    texts = [b"aaa", b"a", b"", b"aaab", b"a" * 301, b"a" * 300]
    data, lens = _pack(texts)
    fl = np.asarray(eng.forward_flags(data, lens, seeded=False))
    for i, t in enumerate(texts):
        # unseeded flags: match starting at 0 ends at e; flags column
        # convention is end = column - 1 (scan_xla.end_positions)
        want = {e for e in orc.ends(t) if orc.fullmatch(t[:e])}
        got = {c - 1 for c in np.nonzero(fl[i])[0] if 1 <= c <= lens[i] + 1}
        assert got == want, (i, got, want)


def test_banded_literal_chain():
    lit = "abcdefgh" * 40  # 320-char literal -> multiblock banded chain
    prog = compile_program(lit)
    assert prog.tier == "multiblock"
    eng = ScanEngine(prog, backend="pallas")
    # no counting plan, more than 32 states: the packed engine serves it
    assert eng.device_scanner is None and eng.backend == "packed"
    orc = OracleEngine.compile(lit)
    texts = [lit.encode(), (lit + "x").encode(), ("xx" + lit).encode(),
             lit[:100].encode(), (lit + lit).encode(), b"zzz", b""]
    data, lens = _pack(texts)
    cnt, first, _ = eng.match_stats(data, lens, seeded=True)
    fm = eng.fullmatch_flags(data, lens)
    for i, t in enumerate(texts):
        ends = orc.ends(t)
        assert int(np.asarray(cnt).reshape(-1)[i]) == len(ends), i
        assert bool(fm[i]) == orc.fullmatch(t), i


# ---------------------------------------------------------------------------
# Stride-k counting: fixed-length multi-class bodies (ab){m,n} etc.
# ---------------------------------------------------------------------------

STRIDE_K = [
    "(ab){2,600}",        # k=2, sparse-size blowup
    "(ab){2,120}",        # k=2, dense256-size
    "(ab){40,}",          # k=2, unbounded
    "(ab){0,40}",         # k=2, nullable
    "(ab){40}",           # k=2, exact
    "([a-c][0-9]){2,80}", # k=2, classes per position
    "(abc){2,100}",       # k=3
    "(abcd){1,60}",       # k=4
]


def _ktexts(rng, n=20, maxlen=260):
    ts = [
        bytes(rng.choice(list(b"abc0123dx"), int(rng.integers(0, maxlen))))
        for _ in range(n)
    ]
    ts += [b"ab" * 130, b"ab" * 120, b"ab" * 2, b"ab", b"", b"a",
           b"abab" + b"x" + b"ab" * 45, b"abc" * 100, b"abcd" * 60,
           b"a1b2" * 40, b"ba" * 50]
    return ts


@pytest.mark.parametrize("pattern", STRIDE_K)
def test_stride_k_plan_detected(pattern):
    prog = compile_program(pattern)
    plan = counting_plan(prog)
    assert plan is not None, pattern
    m, n, branches = plan
    assert len(branches[0]) >= 2  # body length k (per-branch)
    eng = ScanEngine(prog, backend="pallas")
    assert isinstance(eng.device_scanner, CountScanner)


@pytest.mark.parametrize("pattern", STRIDE_K)
def test_stride_k_stats_oracle_parity(pattern):
    prog = compile_program(pattern)
    eng = ScanEngine(prog, backend="pallas")
    assert isinstance(eng.device_scanner, CountScanner)
    orc = OracleEngine.compile(pattern)
    data, lens = _pack(_ktexts(np.random.default_rng(11)))
    cnt, first, anym = eng.match_stats(data, lens, seeded=True)
    cnt = np.asarray(cnt).reshape(-1)
    first = np.asarray(first).reshape(-1)
    fm = eng.fullmatch_flags(data, lens)
    for i in range(len(lens)):
        t = bytes(data[i, : lens[i]])
        ends = orc.ends(t)
        assert int(cnt[i]) == len(ends), (pattern, i, t[:24])
        assert int(first[i]) == (min(ends) if ends else -1), (pattern, i)
        assert bool(fm[i]) == orc.fullmatch(t), (pattern, i, t[:24])


@pytest.mark.parametrize("pattern", ["(ab){2,80}", "(abc){1,50}", "(ab){0,80}"])
def test_stride_k_bitmaps_and_spans(pattern):
    pat = Pattern(pattern, backend="pallas")
    assert isinstance(pat.engine.device_scanner, CountScanner)
    orc = OracleEngine.compile(pattern)
    rng = np.random.default_rng(13)
    texts = [
        bytes(rng.choice(list(b"abcx"), int(rng.integers(0, 90))))
        for _ in range(12)
    ] + [b"ab" * 40, b"abc" * 30, b""]
    data, lens = _pack(texts)
    maxlen = data.shape[1]
    eb = pat.engine.ends_bitmap(data, lens, maxlen)
    sb = pat.engine.starts_bitmap(data, lens, maxlen)
    for i, t in enumerate(texts):
        assert set(np.nonzero(eb[i])[0]) == orc.ends(t), (pattern, i, t[:24])
        assert set(np.nonzero(sb[i])[0]) == orc.starts(t), (pattern, i, t[:24])
    for longest in (False, True):
        spans = pat.finditer_batch(texts, longest=longest)
        for t, sp in zip(texts, spans):
            assert list(sp) == list(orc.finditer(t, longest=longest)), (
                pattern, longest, t[:24],
            )


def test_stride_k_unseeded_flags():
    pat = "(ab){2,120}"
    prog = compile_program(pat)
    eng = ScanEngine(prog, backend="pallas")
    assert isinstance(eng.device_scanner, CountScanner)
    orc = OracleEngine.compile(pat)
    texts = [b"abab", b"ab", b"", b"ababx", b"ab" * 121, b"ab" * 120,
             b"ab" * 7, b"aab"]
    data, lens = _pack(texts)
    fl = np.asarray(eng.forward_flags(data, lens, seeded=False))
    for i, t in enumerate(texts):
        want = {e for e in orc.ends(t) if orc.fullmatch(t[:e])}
        got = {c - 1 for c in np.nonzero(fl[i])[0] if 1 <= c <= lens[i] + 1}
        assert got == want, (i, got, want)


# ---------------------------------------------------------------------------
# Randomized property fuzz: random fixed-length bodies / m / n vs oracle
# ---------------------------------------------------------------------------

def _rand_body_pattern(rng):
    """Random (body_regex, alphabet) with k in 1..4 class positions."""
    k = int(rng.integers(1, 5))
    classes = ["a", "b", "[ab]", "[a-c]", "[bx]", "c"]
    parts = [classes[int(rng.integers(0, len(classes)))] for _ in range(k)]
    body = "".join(parts)
    m = int(rng.integers(0, 5))
    style = int(rng.integers(0, 3))
    if style == 0:
        n = m + int(rng.integers(0, 40))
        quant = f"{{{m},{n}}}"
    elif style == 1:
        quant = f"{{{max(m,1)},}}"
    else:
        quant = f"{{{max(m,1)}}}"
    pat = f"({body}){quant}" if k > 1 else f"{body}{quant}"
    return pat


def test_stride_k_fuzz_vs_oracle():
    rng = np.random.default_rng(2024)
    alphabet = list(b"abcx")
    tried = 0
    for trial in range(40):
        pat = _rand_body_pattern(rng)
        prog = compile_program(pat)
        plan = counting_plan(prog)
        if plan is None:
            continue
        tried += 1
        # fuzz the run-length scanner directly, even where ScanEngine
        # would route a small-S pattern to the packed matrix tier
        cs = CountScanner(prog, plan)
        orc = OracleEngine.compile(pat)
        texts = [
            bytes(rng.choice(alphabet, int(rng.integers(0, 200))))
            for _ in range(10)
        ] + [b"", b"ab" * 64, b"abc" * 40]
        data, lens = _pack(texts)
        cnt, first, _, full, anym = cs.match_stats_b(
            data, lens.reshape(-1, 1), seeded=True
        )
        cnt = np.asarray(cnt).reshape(-1)
        first = np.asarray(first).reshape(-1)
        for i, t in enumerate(texts):
            ends = orc.ends(t)
            assert int(cnt[i]) == len(ends), (pat, i, t[:24])
            assert int(first[i]) == (min(ends) if ends else -1), (pat, i)
    assert tried >= 15, tried  # the generator must mostly hit the plan
