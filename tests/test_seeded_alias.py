"""Seeded-alias rewrite (engine._seeded_alias): whole-pattern X{m,n} on
the big-automaton tiers scans as X{m,} for every seeded primitive — the
upper bound is unobservable when a match may start anywhere (any chain of
L >= m body copies ending/starting at a position contains a min(L, n)-copy
sub-chain). Unseeded scans (fullmatch, greedy rescans) keep the original
program."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from roaringregex.api import Pattern  # noqa: E402
from roaringregex.compiler.program import compile_program  # noqa: E402
from roaringregex.engine import ScanEngine  # noqa: E402
from roaringregex.oracle.engine import OracleEngine  # noqa: E402
from roaringregex.utils.config import get_config, set_config  # noqa: E402


def test_alias_routing_gates():
    # whole-pattern bounded repeat with a variable-length body: aliased
    eng = ScanEngine(compile_program("(abc|de){1,300}"), backend="pallas")
    al = eng._seeded_alias()
    assert al is not None and al.prog.n_states == 6
    # context around the repeat: NOT aliased (the chain must attach)
    assert (
        ScanEngine(compile_program("x(ab|c){400,520}y"), backend="pallas")
        ._seeded_alias() is None
    )
    # counting-plan patterns: run-length tier already collapses them
    assert (
        ScanEngine(compile_program("a{3,1200}"), backend="pallas")
        ._seeded_alias() is None
    )
    # unbounded repeats are already small
    assert (
        ScanEngine(compile_program("(abc|de){2,}"), backend="pallas")
        ._seeded_alias() is None
    )
    # kill switch
    base = get_config()
    try:
        set_config(base.with_(seeded_alias=False))
        eng2 = ScanEngine(
            compile_program("(abc|de){1,300}"), backend="pallas"
        )
        assert eng2._seeded_alias() is None
    finally:
        set_config(base)


def test_alias_long_string_parity():
    """AliasLongScanner: seeded long-string scans of an X{m,n} blowup run
    on the X{m,} alias; fullmatch keeps the original."""
    from roaringregex.ops.longstring import (
        AliasLongScanner,
        make_long_scanner,
    )

    rng = np.random.default_rng(41)
    for pat in ["(abc|de){1,300}", "(ab|c){2,400}"]:
        sc = make_long_scanner(compile_program(pat), block=256)
        assert isinstance(sc, AliasLongScanner), pat
        orc = OracleEngine.compile(pat)
        for t in [b"", b"abcde" * 200, b"de" * 400, b"abc",
                  rng.choice(list(b"abcde"), 1200).astype(np.uint8).tobytes()]:
            assert sc.count_ends(t) == len(orc.ends(t)), (pat, len(t))
            assert sc.search(t) == bool(orc.ends(t)), (pat, len(t))
            assert sc.fullmatch(t) == orc.fullmatch(t), (pat, len(t))
            assert set(np.nonzero(sc.ends_bitmap(t))[0]) == orc.ends(t)


def test_alias_dist_batched_paths():
    """Seeded sharded entry points (stats / per-record / lazy spans) on a
    >1024-state blowup route through the alias DistScanner — including
    sharded span extraction, which the sparse tier alone cannot do."""
    import jax
    from roaringregex.parallel import DistScanner, make_mesh, shard_batch

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(8)
    ds = DistScanner(compile_program("(abc|de){1,300}"), mesh)
    orc = OracleEngine.compile("(abc|de){1,300}")
    recs = [b"abcde" * 6, b"", b"de" * 8, b"xxabc", b"deabcde", b"zzz",
            b"abc", b"dedede"] * 2
    data = np.zeros((16, 64), np.uint8)
    lens = np.zeros(16, np.int32)
    for i, r in enumerate(recs):
        data[i, : len(r)] = np.frombuffer(r, np.uint8)
        lens[i] = len(r)
    d, l = shard_batch(mesh, data, lens)
    _, n, _ = ds.global_stats(d, l)
    assert int(n) == sum(orc.search(r) for r in recs)
    cnt, _, _ = ds.per_record(d, l, seeded=True)
    for i, r in enumerate(recs):
        assert int(np.asarray(cnt)[i]) == len(orc.ends(r)), (i, r)
    s, e, c, o = ds.per_record_spans(d, l, cap=32, longest=False)
    assert not np.asarray(o).any()
    for i, r in enumerate(recs):
        got = list(zip(np.asarray(s)[i, : np.asarray(c)[i]].tolist(),
                       np.asarray(e)[i, : np.asarray(c)[i]].tolist()))
        assert got == list(orc.finditer(r)), (i, r)


def test_alias_dist_long_stats(request):
    """Sharded long-string stats route through the alias DistScanner."""
    import jax
    from roaringregex.parallel import DistScanner, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh")
    mesh = make_mesh(8)
    ds = DistScanner(compile_program("(abc|de){1,300}"), mesh)
    assert ds._alias_dist() is not None
    orc = OracleEngine.compile("(abc|de){1,300}")
    blob = b"x" * 300 + b"abcde" * 120 + b"y" * 200 + b"dede" * 50
    assert ds.long_stats(blob, mode="count") == len(orc.ends(blob))
    assert ds.long_stats(blob, mode="any")
    assert ds.long_count(blob, block=256) == len(orc.ends(blob))


def test_sparse_prefilter_parity():
    """Hyperscan-style prefilter (engine.relaxed_prefilter_program): the
    container kernels run only on compacted candidate records; results
    must be exact for hit-light batches (compacted branch) AND hit-heavy
    batches (candidate count exceeds the bucket -> full-scan branch)."""
    from roaringregex.engine import relaxed_prefilter_program
    from roaringregex.utils.config import get_config, set_config

    pat = "x(ab|c){400,520}y"
    hit = b"x" + b"ab" * 200 + b"c" * 210 + b"y"
    prog = compile_program(pat)
    eng = ScanEngine(prog, backend="pallas")
    assert eng._prefilter() is not None
    assert relaxed_prefilter_program(prog).n_states <= 64
    orc = OracleEngine.compile(pat)
    rng = np.random.default_rng(47)
    texts = [
        rng.choice(list(b"abcxyz"), int(rng.integers(0, 900))).astype(np.uint8).tobytes()
        for _ in range(29)
    ] + [hit, b"", hit + b"tail"]
    L = 1 << (max(len(t) for t in texts) - 1).bit_length()
    data = np.zeros((len(texts), L), np.uint8)
    lens = np.zeros(len(texts), np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lens[i] = len(t)
    cnt, first, anym = map(
        np.asarray, eng.match_stats(data, lens, seeded=True)
    )
    for i, t in enumerate(texts):
        ends = orc.ends(t)
        assert int(cnt[i]) == len(ends), (i, len(t))
        assert int(first[i]) == (min(ends) if ends else -1), i
        assert bool(anym[i]) == bool(ends), i
    # hit-light LARGE batch: B=512 > bucket floor, ~8 candidates ->
    # exercises the compacted branch (nonzero + gather + drop-scatter)
    Bc = 512
    dc = np.zeros((Bc, 1024), np.uint8)
    lc = np.zeros(Bc, np.int32)
    rowsc = []
    for i in range(Bc):
        t = rng.choice(list(b"abcxyz"), int(rng.integers(0, 900))).astype(
            np.uint8
        ).tobytes()
        if i % 61 == 0:
            t = hit if i % 2 else hit + b"tt"
        rowsc.append(t)
        dc[i, : len(t)] = np.frombuffer(t, np.uint8)
        lc[i] = len(t)
    cc, fc, ac = map(np.asarray, eng.match_stats(dc, lc, seeded=True))
    for i, t in enumerate(rowsc):
        ends = orc.ends(t)
        assert int(cc[i]) == len(ends), (i, len(t))
        assert int(fc[i]) == (min(ends) if ends else -1), i
        assert bool(ac[i]) == bool(ends), i
    # hit-heavy: every record a candidate -> lax.cond full branch
    dh = np.zeros((256, 1024), np.uint8)
    lh = np.full(256, len(hit), np.int32)
    dh[:, : len(hit)] = np.frombuffer(hit, np.uint8)
    ch, _, _ = map(np.asarray, eng.match_stats(dh, lh, seeded=True))
    want = len(orc.ends(hit))
    assert all(int(c) == want for c in ch)
    # kill switch
    base = get_config()
    try:
        set_config(base.with_(sparse_prefilter=False))
        eng2 = ScanEngine(compile_program(pat), backend="pallas")
        assert eng2._prefilter() is None
    finally:
        set_config(base)


@pytest.mark.parametrize(
    "pattern", ["(abc|de){1,300}", "(ab|c){2,400}", "(abc|de){3,500}"]
)
def test_alias_public_api_parity(pattern):
    p = Pattern(pattern, backend="pallas")
    assert p.engine._seeded_alias() is not None, pattern
    orc = OracleEngine.compile(pattern)
    rng = np.random.default_rng(hash(pattern) % 2**32)
    texts = [
        rng.choice(list(b"abcde"), int(rng.integers(0, 250))).astype(np.uint8).tobytes()
        for _ in range(13)  # odd B: exercises padding to the alias G
    ] + [b"abcde" * 120, b"", b"abc", b"de" * 200]
    assert list(p.search_batch(texts)) == [orc.search(t) for t in texts]
    assert [int(c) for c in p.count_batch(texts)] == [
        len(orc.ends(t)) for t in texts
    ]
    assert p.ends_batch(texts) == [sorted(orc.ends(t)) for t in texts]
    assert p.starts_batch(texts) == [sorted(orc.starts(t)) for t in texts]
    for longest in (False, True):  # greedy observes the bound (original)
        assert p.finditer_batch(texts, longest=longest) == [
            list(orc.finditer(t, longest=longest)) for t in texts
        ], (pattern, longest)
    assert list(p.fullmatch_batch(texts)) == [
        orc.fullmatch(t) for t in texts
    ]


def test_prefilter_wired_into_all_primitives():
    """Round-5 task: the prefilter compaction covers reverse_hits,
    forward_flags, fullmatch_flags, first_end_from and the span
    enumeration — not just match_stats. Exactness on a hit-light large
    batch (compacted branch) vs the oracle, plus spans via finditer."""
    from roaringregex.api import Pattern

    pat = "x(ab|c){400,520}y"
    hit = b"x" + b"ab" * 200 + b"c" * 210 + b"y"
    p = Pattern(pat, backend="pallas")
    eng = p.engine
    assert eng._prefilter() is not None
    orc = OracleEngine.compile(pat)
    rng = np.random.default_rng(31)
    B, L = 256, 1024
    data = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    rows = []
    for i in range(B):
        t = rng.choice(list(b"abcxyz"), int(rng.integers(0, 900))).astype(
            np.uint8
        ).tobytes()
        if i in (3, 77, 200):
            t = b"qq" + hit + b"zz"
        rows.append(t)
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lens[i] = len(t)
    # reverse_hits through the prefilter
    hits = np.asarray(eng.reverse_hits(data, lens))
    for i in (3, 77, 200, 0, 100):
        t = rows[i]
        starts = {
            max(j - 1, 0)
            for j in np.nonzero(hits[i])[0]
            if j - 1 <= len(t)
        }
        want = {s for (s, _e) in orc.findall(t)}
        assert starts == want, (i, starts, want)
    # fullmatch
    fm = np.asarray(eng.fullmatch_flags(data, lens))
    for i in (3, 77, 0):
        assert bool(fm[i]) == orc.fullmatch(rows[i]), i
    assert bool(
        np.asarray(eng.fullmatch_flags(
            np.frombuffer(hit, np.uint8)[None, :].repeat(256, 0).copy(),
            np.full(256, len(hit), np.int32),
        ))[0]
    ) == orc.fullmatch(hit)
    # spans (lazy + greedy) through engine.lazy_spans/greedy_spans
    got = p.finditer_batch([rows[3], rows[0], rows[77]])
    for t, g in zip([rows[3], rows[0], rows[77]], got):
        assert g == orc.findall(t), len(t)
    gotg = p.finditer_batch([rows[3], rows[0]], longest=True)
    for t, g in zip([rows[3], rows[0]], gotg):
        assert g == orc.findall(t, longest=True), len(t)
