"""Small-automaton (<= 8 states) scans on the ``pallas`` route vs the oracle.

Match statistics run through the Pallas-Triton word kernel (interpret
mode on CPU), everything else through the packed engine. Every output
must agree exactly with the oracle, including the nullable/anchor/
empty-record edges.
"""
import numpy as np
import pytest

from roaringregex import platform
from roaringregex.api import Pattern
from roaringregex.compiler.program import compile_program
from roaringregex.engine import ScanEngine
from roaringregex.ops.scan_word import WordScanner, word_spec
from roaringregex.oracle.engine import OracleEngine
from roaringregex.utils.config import get_config, set_config

from oracle_stats import assert_stats_match_oracle

PATTERNS = [
    "cat|dog",
    "(ab)*c+d?",
    "(cat|dog)*",  # nullable
    "^ab?c$",  # anchors
    "[a-c]x{0,2}$",  # EOS-class gating
    "a*",  # nullable single class
    "(a|b)(c|d)",
    "a\\.b",
    "[^a-c]",  # complement class
    "a+b",
    "a.b",  # '.' position spans several byte classes
    "...",
    "(a|.)c",
    "(a|$)*",  # nullable AND '$' in the first set (empty-record EOS dedup)
    "$?",
    "(a$)?",
    "(^|a)b*",  # nullable AND '^' in the first set
]


def _batch(seed=0, n=60, maxlen=40, L=48, G=16):
    rng = np.random.default_rng(seed)
    texts = [b"", b"cat", b"catdog", b"ababccd", b"abc", b"a.b", b"zzz"]
    for _ in range(n):
        ln = int(rng.integers(0, maxlen))
        texts.append(
            bytes(rng.choice(list(b"abcdogt.caxz"), size=ln).astype(np.uint8))
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
    assert word_spec(prog) is not None, "every test pattern fits the word tier"
    sw = WordScanner(prog)
    data, lengths = _batch(G=prog.G)
    out = sw.match_stats_b(data, lengths.reshape(-1, prog.G), seeded=seeded)
    assert_stats_match_oracle(prog, out, data, lengths, seeded, pattern)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_reverse_hits_parity(pattern):
    prog = compile_program(pattern)
    eng = ScanEngine(prog, backend="pallas")
    orc = OracleEngine(prog.nfa)
    data, lengths = _batch(G=prog.G)
    sb = eng.starts_bitmap(data, lengths, data.shape[1])
    for i in range(len(lengths)):
        t = bytes(data[i, : lengths[i]])
        got = {int(s) for s in np.nonzero(sb[i])[0] if s <= lengths[i]}
        assert got == orc.starts(t), (pattern, t)


@pytest.mark.parametrize(
    "pattern",
    [p for p in PATTERNS if not compile_program(p).nullable],
)
def test_lazy_spans_parity(pattern):
    p = Pattern(pattern, backend="pallas")
    assert p.engine.device_spans
    orc = OracleEngine(p.program.nfa)
    data, lengths = _batch(G=p.program.G)
    texts = [bytes(data[i, : lengths[i]]) for i in range(len(lengths))]
    got = p.finditer_batch(texts)
    assert got == [orc.findall(t) for t in texts], pattern


def test_spec_rejects_wide_tiles():
    # the word tier takes up to 32 states; wider automata stay packed
    assert word_spec(compile_program("(ab|cd)+e{2,3}fgh")) is not None
    assert word_spec(compile_program("a{1,300}")) is None


def test_engine_selects_swar():
    # the routing function: word kernel on the GPU, packed on the CPU
    prog = compile_program("cat|dog")
    assert platform.route(prog, plat="gpu") == ("pallas", "word", True)
    assert platform.route(prog, plat="cpu") == ("packed", None, False)
    eng = ScanEngine(prog, backend="pallas")
    assert isinstance(eng.device_scanner, WordScanner)
    assert eng.backend == "pallas"


def test_engine_window_defers_to_swar():
    # engine-level windowing targets the word kernel (it takes ``lead``);
    # wide tiles (> 32 states) stay on the packed engine and never window
    cfg = get_config()
    try:
        set_config(cfg.with_(window_cols=4096))
        eng = ScanEngine(compile_program("cat|dog"), backend="pallas")
        assert eng._window_plan(4096, 32, True) is not None
        eng2 = ScanEngine(compile_program("a{1,40}"), backend="pallas")
        assert eng2.device_scanner is None
        assert eng2._window_plan(4096, 32, True) is None
    finally:
        set_config(cfg)


def test_engine_match_stats_through_swar():
    prog = compile_program("cat|dog")
    eng = ScanEngine(prog, backend="pallas")
    ref = ScanEngine(prog, backend="packed")
    data, lengths = _batch(seed=3, G=prog.G)
    a = [np.asarray(x) for x in eng.match_stats(data, lengths, seeded=True)]
    b = [np.asarray(x) for x in ref.match_stats(data, lengths, seeded=True)]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        eng.fullmatch_flags(data, lengths), ref.fullmatch_flags(data, lengths)
    )


def test_full_length_records_no_eos_loss():
    # len == L: the EOS step is the final stream step; ensure T covers it
    prog = compile_program("ab$")
    sw = WordScanner(prog)
    G = prog.G
    L = 8
    data = np.tile(np.frombuffer(b"zzzzzzab", np.uint8), (2 * G, 1))
    lengths = np.full(2 * G, L, np.int32)
    out = sw.match_stats_b(data, lengths.reshape(-1, G), seeded=True)
    assert_stats_match_oracle(prog, out, data, lengths, True, "ab$")
    assert np.asarray(out[4]).all()  # every record matches ...ab$


def test_windowed_parity():
    # L large + few records: the engine splits records into overlapped
    # windows for the word kernel; results must equal the unwindowed scan
    prog = compile_program("cat|dog")
    G = prog.G
    rng = np.random.default_rng(7)
    B, L = 2 * G, 1024
    data = rng.choice(
        np.frombuffer(b"abcdogt.ca", np.uint8), size=(B, L)
    ).astype(np.uint8)
    data[0, 100:103] = np.frombuffer(b"cat", np.uint8)
    data[1, 510:513] = np.frombuffer(b"dog", np.uint8)  # straddles w=512?
    data[2, 253:256] = np.frombuffer(b"cat", np.uint8)  # window boundary
    lengths = np.full(B, L, np.int32)
    lengths[3] = 0
    lengths[4] = 257
    old = get_config()
    try:
        set_config(old.with_(window_cols=256))
        eng = ScanEngine(prog, backend="pallas")
        assert eng._window_plan(L, B, True) is not None, "window should trigger"
        a = eng.match_stats(data, lengths, seeded=True)
        set_config(old.with_(window_cols=0))
        assert eng._window_plan(L, B, True) is None
        b = eng.match_stats(data, lengths, seeded=True)
    finally:
        set_config(old)
    for name, x, y in zip(["cnt", "first", "any"], a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=name)


def test_high_bytes_are_dead():
    # bytes >= 0x80 must not alias the BOS/EOS/dead sentinels
    prog = compile_program("a.b")  # '.' covers 0..0x7F only
    sw = WordScanner(prog)
    G = prog.G
    data = np.zeros((G, 8), np.uint8)
    rows = [b"a\xfeb", b"a\xffb", b"a\xfdb", b"axb"]
    lengths = np.zeros(G, np.int32)
    for i, t in enumerate(rows):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    out = sw.match_stats_b(data, lengths.reshape(-1, G), seeded=True)
    assert_stats_match_oracle(prog, out, data, lengths, True, "a.b")
    anym = np.asarray(out[4]).reshape(-1)
    assert list(anym[:4]) == [False, False, False, True]
