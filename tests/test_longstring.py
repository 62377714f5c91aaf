"""Long-string (block-parallel) scan vs oracle.

The associative block-summary scheme must reproduce the oracle's ends()
and fullmatch() exactly, for every block size (including block sizes that
straddle match boundaries) and both seeded and anchored conventions.
"""
import numpy as np
import pytest

from roaringregex.compiler.program import compile_program
from roaringregex.ops.longstring import LongScanner
from roaringregex.oracle.engine import OracleEngine

PATTERNS = ["cat|dog", "(ab)*c+d?", "a{2,9}", "^ab", "ab$", "(cat|dog)*",
            "[a-c]+x"]



_TESTS_PER_CLEAR = [0]


@pytest.fixture(autouse=True)
def _clear_caches_periodically():
    """This module compiles the largest program population of the suite
    (summary+replay, windows, counting, dotstar, reversed-program
    variants); the XLA CPU runtime aborts when too many executables
    accumulate in one process (see conftest's per-module clear), so
    clear every few tests here to bound the population."""
    yield
    _TESTS_PER_CLEAR[0] += 1
    if _TESTS_PER_CLEAR[0] % 4 == 0:
        import gc

        import jax

        gc.collect()
        jax.clear_caches()


def _texts(rng, n=6, L=200):
    out = [b"", b"cat", b"catdog" * 20]
    for _ in range(n):
        ln = int(rng.integers(1, L))
        out.append(
            bytes(rng.choice(list(b"abcdtogx"), size=ln).astype(np.uint8))
        )
    return out


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("block", [16, 64, 1024])
def test_long_ends_match_oracle(pattern, block):
    prog = compile_program(pattern)
    oracle = OracleEngine(prog.nfa)
    sc = LongScanner(prog, block=block)
    rng = np.random.default_rng(5)
    for t in _texts(rng):
        exp = oracle.ends(t)
        got = set(np.nonzero(sc.ends_bitmap(t))[0].tolist())
        assert got == exp, (pattern, block, t[:40])


@pytest.mark.parametrize("pattern", PATTERNS)
def test_long_fullmatch_match_oracle(pattern):
    prog = compile_program(pattern)
    oracle = OracleEngine(prog.nfa)
    sc = LongScanner(prog, block=32)
    rng = np.random.default_rng(6)
    for t in _texts(rng):
        assert sc.fullmatch(t) == oracle.fullmatch(t), (pattern, t[:40])


def test_long_blocks_beat_sequential_equivalence():
    """A long string whose matches straddle many block boundaries."""
    prog = compile_program("ab(cd)+e")
    oracle = OracleEngine(prog.nfa)
    sc = LongScanner(prog, block=8)  # tiny blocks, matches cross boundaries
    t = (b"xx" + b"abcdcdcde" * 50)[:401]
    assert set(np.nonzero(sc.ends_bitmap(t))[0].tolist()) == oracle.ends(t)


@pytest.mark.parametrize("pattern", ["cat|dog", "(ab)*c+d?", "^ab", "ab$",
                                     "(cat|dog)*", "[a-c]+x"])
def test_fast_long_scanner_matches_oracle(pattern):
    from roaringregex.ops.longstring import FastLongScanner

    prog = compile_program(pattern)
    oracle = OracleEngine(prog.nfa)
    sc = FastLongScanner(prog, block=128)  # small blocks, many boundaries
    rng = np.random.default_rng(11)
    texts = [b"", b"cat", b"catdog" * 30, b"ab" * 100 + b"ccd"]
    for _ in range(4):
        ln = int(rng.integers(1, 500))
        texts.append(bytes(rng.choice(list(b"abcdtogx"), size=ln).astype(np.uint8)))
    for t in texts:
        got = set(np.nonzero(sc.ends_bitmap(t))[0].tolist())
        assert got == oracle.ends(t), (pattern, len(t))
        assert sc.fullmatch(t) == oracle.fullmatch(t), (pattern, len(t))


def test_make_long_scanner_dispatch():
    from roaringregex.ops.longstring import (
        FastLongScanner, LongScanner, make_long_scanner,
    )

    from roaringregex.ops.longstring import CountLongScanner

    assert isinstance(make_long_scanner(compile_program("cat|dog")), FastLongScanner)
    # counting-plan patterns on one-record-per-row tiers: run-length windows
    assert isinstance(make_long_scanner(compile_program("a{1,300}")), CountLongScanner)
    assert isinstance(make_long_scanner(compile_program("(ab){2,600}")), CountLongScanner)
    # big-S acyclic patterns: overlapped windows on the wide tile
    wide = make_long_scanner(compile_program("a{140}b{150}"))
    assert isinstance(wide, FastLongScanner) and wide.overlap is not None
    # big-S cyclic, no counting plan: portable summary path
    assert isinstance(
        make_long_scanner(compile_program("a{140}b{150}(xy)*z")), LongScanner
    )


def test_pattern_long_api():
    import roaringregex as rrx

    p = rrx.Pattern("cat|dog")
    blob = b"x" * 5000 + b"cat" + b"y" * 5000 + b"dog"
    assert p.long.count_ends(blob) == 2
    assert p.long.search(blob) and not p.long.fullmatch(blob)
    assert p.long.fullmatch(b"cat")


def test_fast_long_mode_selection():
    """Bounded-horizon anchor-free patterns take the overlapped windows;
    cyclic patterns fall back to summary+replay; tiny blocks force
    summary mode when the horizon exceeds the overlap budget."""
    from roaringregex.ops.longstring import FastLongScanner

    ov = FastLongScanner(compile_program("cat|dog"), block=16384)
    assert ov.overlap is not None and ov.prog.horizon == 3
    cyc = FastLongScanner(compile_program("(ab)*c+d?"), block=16384)
    assert cyc.overlap is None and cyc.prog.horizon is None
    # horizon 20 > 128 // 8: summary mode despite being acyclic
    big = FastLongScanner(compile_program("a{1,20}"), block=128)
    assert big.prog.horizon == 20 and big.overlap is None


def test_fast_long_q_packing():
    """A cyclic pattern has no windows: its long scan is the portable
    summary+replay scanner, exact on block-crossing inputs."""
    from roaringregex.ops.longstring import FastLongScanner, LongScanner

    sc = FastLongScanner(compile_program("(cat|dog)*"), block=128)
    assert sc.overlap is None and isinstance(sc.summary, LongScanner)
    oracle = OracleEngine(sc.prog.nfa)
    t = b"catdog" * 100 + b"x" + b"cat" * 30
    assert set(np.nonzero(sc.ends_bitmap(t))[0].tolist()) == oracle.ends(t)


def test_fast_long_rows_pb_gt_1():
    """A cyclic pattern with more states than a packed row holds (S > G):
    summary+replay over block-crossing matches, vs the oracle."""
    from roaringregex.ops.longstring import FastLongScanner

    pattern = "(abcdefghijklmnopqrst)*x"
    prog = compile_program(pattern)
    sc = FastLongScanner(prog, block=128)
    assert prog.n_states > prog.G and sc.overlap is None
    oracle = OracleEngine(prog.nfa)
    texts = [b"abcdefghijklmnopqrst" * 20 + b"x",
             b"abcdefghijklmnopqrst" * 7,
             b"x" + b"abcdefghijklmnopqrst" * 13 + b"x"]
    for t in texts:
        got = set(np.nonzero(sc.ends_bitmap(t))[0].tolist())
        assert got == oracle.ends(t), len(t)
        assert sc.fullmatch(t) == oracle.fullmatch(t), len(t)


def test_fast_long_anchors_at_window_boundaries():
    """^ must not fire at interior block starts and $ only at the true
    EOS — anchored patterns take the summary path, never windows."""
    from roaringregex.ops.longstring import FastLongScanner

    for pattern in ("^ab", "ab$", "^ab.*cd$"):
        prog = compile_program(pattern)
        sc = FastLongScanner(prog, block=128)
        assert sc.overlap is None
        oracle = OracleEngine(prog.nfa)
        for t in (b"ab" + b"xy" * 300, b"xy" * 300 + b"ab",
                  b"ab" + b"q" * 507 + b"cd"):
            got = set(np.nonzero(sc.ends_bitmap(t))[0].tolist())
            assert got == oracle.ends(t), (pattern, len(t))


def test_finditer_long_matches_oracle():
    """Span extraction over ONE long string: candidate starts from the
    overlapped reverse pass, ends from slice-batched anchored rescans,
    host sweep for the non-overlap policy — vs the oracle, both policies,
    with matches planted across window boundaries."""
    import roaringregex as rrx
    from roaringregex.utils.config import get_config, set_config

    base = get_config()
    rng = np.random.default_rng(17)
    body = bytearray(rng.choice(list(b"qwerty"), size=2000).astype(np.uint8))
    body[250:253] = b"cat"  # straddles the 256-block boundary? near it
    body[254:257] = b"dog"
    body[1023:1026] = b"cat"  # exactly across block 3->4 at block=256
    t = b"ab" + bytes(body) + b"ab"
    try:
        set_config(base.with_(long_block=256))
        for pattern in ("cat|dog", "^ab", "ab$", "ca?t", "(cat)?", "qw{1,4}"):
            p = rrx.Pattern(pattern)
            orc = OracleEngine(p.program.nfa)
            assert p.finditer_long(t) == orc.findall(t), pattern
            assert p.finditer_long(t, longest=True) == orc.findall(
                t, longest=True
            ), pattern
    finally:
        set_config(base)


def test_finditer_long_cyclic():
    """Cyclic (unbounded-match-length) patterns: spans over one long
    string via the reversed-program start scan + doubling-window ends
    (round-5 task; the bounded-horizon wall is gone)."""
    import roaringregex as rrx

    rng = np.random.default_rng(6)
    base = bytes(rng.choice(list(b"abcdert og"), size=1100).astype(np.uint8))
    text = (
        base[:400] + b"cat" + base[400:800] + b"abababc"
        + base[800:] + b"dog"
    )
    for pattern in ["(ab)*c", ".*(cat|dog).*"]:
        p = rrx.Pattern(pattern)
        orc = OracleEngine(p.program.nfa)
        for longest in (False, True):
            got = p.finditer_long(text, longest=longest)
            want = orc.findall(text, longest=longest)
            assert got == want, (pattern, longest, got[:4], want[:4])
    # nullable cyclic: lazy = empty match everywhere, greedy via claims
    pn = rrx.Pattern("(ab)*")
    t2 = b"xabababy"
    assert pn.finditer_long(t2) == [(p, p) for p in range(len(t2) + 1)]
    orc = OracleEngine(pn.program.nfa)
    assert pn.finditer_long(t2, longest=True) == orc.findall(
        t2, longest=True
    )


# ---------------------------------------------------------------------------
# CountLongScanner: run-length overlapped windows for counting-plan patterns
# ---------------------------------------------------------------------------


def _blob(rng, n, alphabet=b"aabx"):
    return bytes(rng.choice(list(alphabet), n).astype(np.uint8))


@pytest.mark.parametrize(
    "pattern", ["a{2,5}", "a{3,}", "(ab){2,4}", "[a-c]{2,6}", "(ab){3,}",
                "a{4}", "(ab|ca){2,5}", "(ab|cb){3,}"]
)
def test_count_long_oracle_parity(pattern):
    """Stats and bitmaps across window boundaries must match the oracle
    (tiny 128-byte windows force many boundary crossings)."""
    from roaringregex.ops.longstring import CountLongScanner
    from roaringregex.ops.scan_count import counting_plan
    from roaringregex.oracle.engine import OracleEngine

    prog = compile_program(pattern)
    plan = counting_plan(prog)
    assert plan is not None
    sc = CountLongScanner(prog, plan, block=128)
    orc = OracleEngine.compile(pattern)
    rng = np.random.default_rng(17)
    texts = [
        _blob(rng, 700), _blob(rng, 513, b"ab"), _blob(rng, 400, b"abc"),
        b"a" * 500, b"ab" * 250, b"", b"a", b"ab", (b"a" * 7 + b"x") * 40,
    ]
    for t in texts:
        ends = orc.ends(t)
        cnt, first, last = sc.long_stats(t)
        assert cnt == len(ends), (pattern, len(t), cnt, len(ends))
        assert first == (min(ends) if ends else -1), (pattern, len(t))
        assert last == (max(ends) if ends else -1), (pattern, len(t))
        assert sc.count_ends(t) == len(ends)
        assert sc.search(t) == bool(ends)
        assert sc.fullmatch(t) == orc.fullmatch(t), (pattern, t[:24])
        eb = sc.ends_bitmap(t)
        assert set(np.nonzero(eb)[0]) == ends, (pattern, len(t))
        sb = sc.starts_bitmap(t)
        assert set(np.nonzero(sb)[0]) == orc.starts(t), (pattern, len(t))


def test_count_long_finditer():
    """finditer_long routes candidate starts through CountLongScanner's
    reverse windows for bounded-horizon counting patterns."""
    import roaringregex as rrx
    from roaringregex.ops.longstring import CountLongScanner
    from roaringregex.oracle.engine import OracleEngine

    pat = rrx.Pattern("a{1,300}")
    assert isinstance(pat.long, CountLongScanner)
    rng = np.random.default_rng(19)
    blob = (b"a" * 500 + b"x") * 3 + b"a" * 20 + _blob(rng, 800)
    orc = OracleEngine.compile("a{1,300}")
    assert pat.long.count_ends(blob) == len(orc.ends(blob))
    for longest in (False, True):
        got = pat.finditer_long(blob, longest=longest)
        want = list(orc.finditer(blob, longest=longest))
        assert got == want, (longest, got[:4], want[:4])


def test_count_long_unbounded_cyclic_stats():
    """X{m,} has a cyclic follow graph (no FastLongScanner overlapped
    mode, no finite horizon), but the counting windows stay exact and the
    closed-form span enumeration still works."""
    import roaringregex as rrx
    from roaringregex.ops.longstring import CountLongScanner
    from roaringregex.oracle.engine import OracleEngine

    pat = rrx.Pattern("(ab){130,}")
    assert isinstance(pat.long, CountLongScanner)
    blob = b"ab" * 400 + b"x" + b"ab" * 200
    orc = OracleEngine.compile("(ab){130,}")
    assert pat.long.count_ends(blob) == len(orc.ends(blob))
    assert pat.long.fullmatch(b"ab" * 300)
    assert not pat.long.fullmatch(b"ab" * 129)
    for longest in (False, True):
        assert pat.finditer_long(blob, longest=longest) == list(
            orc.finditer(blob, longest=longest)
        )


@pytest.mark.parametrize(
    "pattern",
    ["a{2,5}", "a{3,}", "(ab){2,4}", "(ab){3,}", "[a-c]{2,6}", "a{4}"],
)
def test_count_long_closed_form_spans(pattern):
    """finditer_long for counting patterns = closed-form run-length walk
    (lazy match = exactly m copies; greedy = min(copies, n))."""
    import roaringregex as rrx
    from roaringregex.ops.longstring import CountLongScanner
    from roaringregex.oracle.engine import OracleEngine

    pat = rrx.Pattern(pattern)
    assert isinstance(pat.long, CountLongScanner)
    orc = OracleEngine.compile(pattern)
    rng = np.random.default_rng(37)
    texts = [
        bytes(rng.choice(list(b"aabx"), 1200).astype(np.uint8)),
        bytes(rng.choice(list(b"ab"), 900).astype(np.uint8)),
        b"a" * 500, b"ab" * 250, b"", b"a", (b"a" * 7 + b"x") * 50,
    ]
    for t in texts:
        for longest in (False, True):
            want = list(orc.finditer(t, longest=longest))
            got = pat.finditer_long(t, longest=longest)
            assert got == want, (pattern, longest, len(t))


@pytest.mark.parametrize("pattern,blk", [
    ("a{20}b{22}", 1024),      # s_tile 64, G=2
    ("a{40}b{45}", 2048),      # s_tile 128, G=1
    ("a{140}b{150}", 4096),    # multiblock s_tile 384
])
def test_fast_long_wide_tiles(pattern, blk):
    """Overlapped windows on wide tiles (s_tile > 32): seeded stats and
    bitmaps at kernel rate; unseeded fullmatch delegates to the portable
    summary scanner."""
    from roaringregex.ops.longstring import FastLongScanner

    prog = compile_program(pattern)
    assert prog.s_tile > 32
    sc = FastLongScanner(prog, block=blk)
    assert sc.overlap is not None
    orc = OracleEngine(prog.nfa)
    rng = np.random.default_rng(43)
    body = pattern.replace("{", "").replace("}", "")
    texts = [
        b"a" * 140 + b"b" * 150,
        (b"a" * 140 + b"b" * 150) * 3,
        bytes(rng.choice(list(b"ab"), 3000).astype(np.uint8)),
        b"x" * 1500 + b"a" * 140 + b"b" * 150 + b"y" * 700,
        b"", b"ab",
    ]
    for t in texts:
        got = set(np.nonzero(sc.ends_bitmap(t))[0].tolist())
        assert got == orc.ends(t), (pattern, len(t))
        assert sc.count_ends(t) == len(orc.ends(t))
        assert sc.fullmatch(t) == orc.fullmatch(t), (pattern, len(t))


def test_finditer_long_empty_input():
    """Empty input must not crash the candidate-slice path (regression:
    arr[-1] gather on a zero-length array)."""
    import roaringregex as rrx

    assert rrx.Pattern("a{0,5}").finditer_long(b"", longest=True) == [(0, 0)]
    assert rrx.Pattern("x?").finditer_long(b"") == [(0, 0)]
    assert rrx.Pattern("ca?t").finditer_long(b"") == []
    assert rrx.Pattern("^").finditer_long(b"") == [(0, 0)]


@pytest.mark.parametrize(
    "pattern",
    [".*error.*", ".*(cat|dog).*", "abc.*", ".*abc", ".*a{2,40}.*",
     ".*(er|ro)r.*"],
)
def test_dotstar_rewrite_oracle_parity(pattern):
    """`.*X.*`-shaped patterns must route to the DotStarLongScanner and
    match the oracle exactly — including dead (>= 0x80) bytes that break
    a trailing `.*` and force the segmented epilogue."""
    from roaringregex.ops.longstring import (
        DotStarLongScanner,
        make_long_scanner,
    )
    from roaringregex.oracle.engine import OracleEngine

    prog = compile_program(pattern)
    sc = make_long_scanner(prog, block=256)
    assert isinstance(sc, DotStarLongScanner), pattern
    orc = OracleEngine.compile(pattern)
    rng = np.random.default_rng(31)
    texts = [
        b"", b"error", b"xerrorx", b"abc" + b"\xf0" + b"zzz",
        b"q" * 300 + b"error" + b"\xf0" + b"y" * 200 + b"error" + b"z" * 10,
        bytes(rng.choice(list(b"abcderotxygz"), 900).astype(np.uint8)),
        b"a" * 45, b"cat" + b"\xf0" * 3 + b"dog" + b"z" * 5,
        b"\xf0" * 20,
    ]
    for t in texts:
        ends = orc.ends(t)
        assert sc.count_ends(t) == len(ends), (pattern, len(t))
        assert sc.search(t) == bool(ends), (pattern, len(t))
        assert set(np.nonzero(sc.ends_bitmap(t))[0]) == ends, (
            pattern, t[:24],
        )
        assert sc.fullmatch(t) == orc.fullmatch(t), (pattern, t[:24])


def test_dotstar_rewrite_gates():
    """Patterns the rewrite must NOT claim: inner .*, nullable cores,
    bounded-horizon patterns (already fast), anchored cores."""
    from roaringregex.ops.longstring import (
        DotStarLongScanner,
        make_long_scanner,
    )

    for pat in ["x.*y", "cat|dog", ".*a*", "(ab)*c"]:
        sc = make_long_scanner(compile_program(pat), block=256)
        assert not isinstance(sc, DotStarLongScanner), pat


def test_speculative_cyclic_validation():
    """Cyclic patterns have no window horizon: FastLongScanner takes the
    summary+replay path, which must be exact for convergent inputs and for
    long-memory ones (a b-run longer than any warmup separating an anchor
    char from its closer)."""
    from roaringregex.ops.longstring import FastLongScanner
    from roaringregex.oracle.engine import OracleEngine

    rng = np.random.default_rng(37)
    for pat in ("(ab)*c", "(cat|dog)*x", "a(bb)*c"):
        prog = compile_program(pat)
        sc = FastLongScanner(prog, block=256)
        assert sc.overlap is None, pat
        orc = OracleEngine.compile(pat)
        texts = [
            b"ababc" * 100,
            bytes(rng.choice(list(b"abcdogtx"), 1500).astype(np.uint8)),
            b"a" + b"b" * 602 + b"c",  # long memory
            b"x" * 700 + b"catdogx" + b"y" * 300,
        ]
        for t in texts:
            assert sc.count_ends(t) == len(orc.ends(t)), (pat, len(t))
            assert sc.search(t) == bool(orc.ends(t)), (pat, len(t))


def test_count_long_run_duck_types_fast_scanner():
    """CountLongScanner._run must honor the (seeded, mode) contract of
    FastLongScanner._run: mode 'full' is whole-string acceptance, not the
    seeded search-anywhere result, and unsupported combos raise."""
    from roaringregex.ops.longstring import CountLongScanner
    from roaringregex.ops.scan_count import counting_plan

    prog = compile_program("a{2,3}")
    sc = CountLongScanner(prog, counting_plan(prog), block=128)

    # search-anywhere hits but fullmatch must not
    assert bool(sc._run(b"xaax", True, "any"))
    assert not bool(sc._run(b"xaax", False, "full"))
    assert bool(sc._run(b"aa", False, "full"))
    assert int(sc._run(b"xaax", True, "count")) == 1

    with pytest.raises(ValueError):
        sc._run(b"xaax", True, "flags")
    with pytest.raises(ValueError):
        sc._run(b"xaax", False, "count")
