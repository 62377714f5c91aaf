"""Raw-byte entry points of the ``pallas`` route (interpret mode on CPU).

The route's scanners consume raw corpus bytes and translate byte->gate
in-kernel (word kernel) or in one fused pass (packed engine); they must
agree exactly with the packed engine fed a precomputed class/mask stream
(itself parity-tested against the unpacked engine and the oracle). Also
covers the greedy (leftmost-longest) anchored rescan against a
brute-force oracle walk.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from roaringregex.compiler.program import compile_program
from roaringregex.engine import ScanEngine
from roaringregex.ops import scan_packed as sp
from roaringregex.ops import scan_xla as sx
from roaringregex.oracle.engine import OracleEngine

PATTERNS = [
    "cat|dog",            # tile 8, G=16, r=2
    "(ab|cd)+e{2,3}fgh",  # tile 16, G=8, r=4
    "a{1,25}",            # tile 32, G=4, r=8
    "[a-f]{10,55}",       # tile 64, G=2, r=8
    "a{1,120}",           # tile 128, G=1, r=8
    "a{1,200}",           # tile 256 (dense256)
    "a{1,300}",           # tile 384 (multiblock)
    "(cat|dog)*",         # nullable
    "^ab?c$",             # anchors
]


def _setup(pattern, seed=0, n=40, maxlen=30, L=32):
    prog = compile_program(pattern)
    tab_p = sp.packed_tables(prog)
    eng = ScanEngine(prog, backend="pallas")
    rng = np.random.default_rng(seed)
    texts = [b"", b"cat", b"catdog", b"ababccd", b"abc", b"aaaaa"]
    for _ in range(n):
        ln = int(rng.integers(0, maxlen))
        texts.append(
            bytes(rng.choice(list(b"abcdefgcat.dog"), size=ln).astype(np.uint8))
        )
    G = prog.G
    Bp = max(G, ((len(texts) + G - 1) // G) * G)
    data = np.zeros((Bp, L), np.uint8)
    lengths = np.zeros(Bp, np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    tab_u = sx.device_tables(prog)
    cls = sx.encode_stream(
        tab_u, jnp.asarray(data), jnp.asarray(lengths),
        prog.bos_class, prog.eos_class, prog.dead_class,
    )
    words = sp.pack_mask_stream(tab_p, cls, s_tile=prog.s_tile, G=prog.G)
    len_g = jnp.asarray(lengths).reshape(-1, prog.G)
    return prog, eng, tab_p, data, lengths, words, len_g, texts


def _last_full(eng, data, lengths):
    """(seeded last end, unseeded whole-record acceptance) per record:
    the stats scanner's fused outputs where the route has one, else the
    plain path's ends bitmap and fullmatch flags."""
    sc = eng.device_scanner
    if sc is not None:
        len_g = np.asarray(lengths).reshape(-1, eng.prog.G)
        last = sc.match_stats_b(data, len_g, seeded=True)[2]
        full = sc.match_stats_b(data, len_g, seeded=False)[3]
        return np.asarray(last).reshape(-1), np.asarray(full).reshape(-1)
    eb = eng.ends_bitmap(data, lengths, data.shape[1])
    last = np.array([
        max((int(e) for e in np.nonzero(eb[i])[0] if e <= lengths[i]),
            default=-1)
        for i in range(len(lengths))
    ])
    return last, np.asarray(eng.fullmatch_flags(data, lengths))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_bytes_match_stats_parity(pattern):
    prog, eng, tab_p, data, lengths, words, len_g, _ = _setup(pattern)
    for seeded in (True, False):
        cs, fs, as_ = sp.match_stats(
            tab_p, words, len_g, seeded=seeded, nullable=prog.nullable,
            lanes=prog.lanes,
        )
        cb, fb, ab = eng.match_stats(data, lengths, seeded=seeded)
        np.testing.assert_array_equal(np.asarray(cs).reshape(-1), np.asarray(cb), err_msg=pattern)
        np.testing.assert_array_equal(np.asarray(fs).reshape(-1), np.asarray(fb), err_msg=pattern)
        np.testing.assert_array_equal(np.asarray(as_).reshape(-1), np.asarray(ab), err_msg=pattern)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_bytes_flags_reverse_parity(pattern):
    prog, eng, tab_p, data, lengths, words, len_g, _ = _setup(pattern, seed=1)
    for seeded in (True, False):
        fls = np.asarray(
            sp.forward_flags(tab_p, words, seeded=seeded, lanes=prog.lanes)
        )
        flb = np.asarray(eng.forward_flags(data, lengths, seeded=seeded))
        np.testing.assert_array_equal(fls, flb, err_msg=f"{pattern} {seeded}")
    hs = np.asarray(sp.reverse_hits(tab_p, words, lanes=prog.lanes))
    hb = np.asarray(eng.reverse_hits(data, lengths))
    np.testing.assert_array_equal(hs, hb, err_msg=pattern)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_bytes_last_full_oracle(pattern):
    """The fused outputs: last match end + whole-record acceptance."""
    prog, eng, tab_p, data, lengths, _, len_g, texts = _setup(pattern, seed=2)
    oracle = OracleEngine(prog.nfa)
    lb, full_anch = _last_full(eng, data, lengths)
    for i, t in enumerate(texts):
        ends = sorted(oracle.ends(t))
        want_last = ends[-1] if ends else -1
        if prog.nullable:
            want_last = len(t)  # seeded empty match at every position
        assert lb[i] == want_last, (pattern, t, lb[i], want_last)
        assert bool(full_anch[i]) == oracle.fullmatch(t), (pattern, t)


@pytest.mark.parametrize("pattern", ["cat|dog", "(ab)+", "a{2,6}", "[a-c]+x?"])
def test_greedy_anchor_end(pattern):
    """longest=True returns the largest end of a match anchored at s."""
    prog, eng, tab_p, data, lengths, _, len_g, texts = _setup(pattern, seed=3)
    oracle = OracleEngine(prog.nfa)
    rng = np.random.default_rng(5)
    starts = np.where(
        rng.random(data.shape[0]) < 0.8,
        rng.integers(0, 8, data.shape[0]),
        -1,
    ).astype(np.int32)
    le = np.asarray(
        eng.first_end_from(data, lengths, starts, longest=True)
    ).reshape(-1)
    fe = np.asarray(
        eng.first_end_from(data, lengths, starts, longest=False)
    ).reshape(-1)
    for i, t in enumerate(texts):
        s = int(starts[i])
        if s < 0 or s > len(t):
            continue
        # brute force: all ends e >= s with t[s:e] accepted
        ends = [
            e for e in range(s, len(t) + 1) if oracle.fullmatch(t[s:e])
        ]
        # oracle.fullmatch('') covers nullable; the scan reports only
        # e > s accepts for nullable (empty anchored match handled by the
        # caller)
        ends_k = [e for e in ends if not (prog.nullable and e == s)]
        want_first = min(ends_k) if ends_k else -1
        want_last = max(ends_k) if ends_k else -1
        assert fe[i] == want_first, (pattern, t, s, fe[i], want_first)
        assert le[i] == want_last, (pattern, t, s, le[i], want_last)


def test_bytes_multi_chunk_grid():
    """B and L big enough for several record blocks and a long byte loop:
    every primitive of the route on raw bytes vs the packed engine on a
    precomputed mask stream."""
    prog = compile_program("cat|dog")
    tab_p = sp.packed_tables(prog)
    eng = ScanEngine(prog, backend="pallas")
    tab_u = sx.device_tables(prog)
    rng = np.random.default_rng(3)
    G = prog.G
    B, L = 64 * G, 600  # 1024 records, 602 stream steps
    data = rng.integers(97, 123, size=(B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    cls = sx.encode_stream(
        tab_u, jnp.asarray(data), jnp.asarray(lengths),
        prog.bos_class, prog.eos_class, prog.dead_class,
    )
    words = sp.pack_mask_stream(tab_p, cls, s_tile=prog.s_tile, G=prog.G)
    len_g = jnp.asarray(lengths).reshape(-1, G)
    cs, fs, _ = sp.match_stats(
        tab_p, words, len_g, seeded=True, nullable=False, lanes=prog.lanes
    )
    cb, fb, _ = eng.match_stats(data, lengths, seeded=True)
    np.testing.assert_array_equal(np.asarray(cs).reshape(-1), np.asarray(cb))
    np.testing.assert_array_equal(np.asarray(fs).reshape(-1), np.asarray(fb))
    hs = np.asarray(sp.reverse_hits(tab_p, words, lanes=prog.lanes))
    hb = np.asarray(eng.reverse_hits(data, lengths))
    np.testing.assert_array_equal(hs, hb)
    for seeded in (True, False):
        fls = np.asarray(
            sp.forward_flags(tab_p, words, seeded=seeded, lanes=prog.lanes)
        )
        flb = np.asarray(eng.forward_flags(data, lengths, seeded=seeded))
        np.testing.assert_array_equal(fls, flb)


def test_sparse_bytes_parity():
    """Sparse-tier counting program on the route (run-length scanner) vs
    the unpacked XLA engine."""
    prog = compile_program("a{3,1200}")
    assert prog.tier == "sparse"
    eng = ScanEngine(prog, backend="pallas")
    assert eng.route.kernel == "count"
    tab_u = sx.device_tables(prog)
    texts = [b"", b"aa", b"aaa", b"a" * 40, b"b" + b"a" * 5]
    L = 64
    data = np.zeros((len(texts), L), np.uint8)
    lengths = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    cls = sx.encode_stream(
        tab_u, jnp.asarray(data), jnp.asarray(lengths),
        prog.bos_class, prog.eos_class, prog.dead_class,
    )
    for seeded in (True, False):
        cu, fu, au = sx.match_stats(
            tab_u, cls, jnp.asarray(lengths), seeded=seeded,
            nullable=prog.nullable,
        )
        cb, fb, ab = eng._match_stats_raw(data, lengths, seeded=seeded)
        np.testing.assert_array_equal(np.asarray(cu), np.asarray(cb))
        np.testing.assert_array_equal(np.asarray(fu), np.asarray(fb))


CHAIN_PATTERNS = [
    "cat|dog",        # tile 8, G=16
    "[a-z]+\\.log$",  # end anchor
    "(ab)*c+d?",      # kleene
    "a*",             # nullable
    "^ab",            # begin anchor
    "a$^b",           # adversarial: follow($) = {^} must NOT leak across
                      # a record boundary
    "(a$|b)c?",       # mid-pattern anchor alternation
]


@pytest.mark.parametrize("pattern", CHAIN_PATTERNS)
def test_chained_match_stats_parity(pattern):
    """Many short records (several per record block, zero bytes, anchors,
    nullable patterns, fullmatch via seeded=False): the word kernel's
    per-record stats must equal the oracle's for every policy."""
    from roaringregex.ops.scan_word import WordScanner

    from oracle_stats import assert_stats_match_oracle

    prog = compile_program(pattern)
    sc = WordScanner(prog)
    rng = np.random.default_rng(7)
    G = max(1, prog.G)
    for B, L in [(4 * G, 12), (8 * G, 30), (16 * G, 7)]:
        alpha = np.frombuffer(b"abcd. \x00xyzgtol", np.uint8)
        data = alpha[rng.integers(0, len(alpha), size=(B, L))].astype(np.uint8)
        lens = rng.integers(0, L + 1, size=B).astype(np.int32)
        for seeded in (True, False):
            got = sc.match_stats_b(data, lens.reshape(-1, G), seeded=seeded)
            assert_stats_match_oracle(
                prog, got, data, lens, seeded, f"{pattern!r} B={B} L={L}"
            )
