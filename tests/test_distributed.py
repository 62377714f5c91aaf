"""Distributed runtime tests on the 8-device virtual CPU mesh.

SURVEY.md §4.2: multi-chip collectives are tested with
``--xla_force_host_platform_device_count`` (set in conftest.py) — the
standard fake-cluster pattern; the same code path runs on real ICI.
"""
import numpy as np
import pytest

import jax

from roaringregex.compiler.program import compile_program
from roaringregex.oracle.engine import OracleEngine
from roaringregex.parallel import DistScanner, make_mesh, shard_batch


def _pack(records, B_pad, L_pad):
    data = np.zeros((B_pad, L_pad), dtype=np.uint8)
    lengths = np.zeros(B_pad, dtype=np.int32)
    for i, r in enumerate(records):
        data[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
        lengths[i] = len(r)
    return data, lengths


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


RECORDS = [
    b"catdog",
    b"dog",
    b"bird",
    b"catcatcat",
    b"",
    b"cccatdoggg",
    b"dogcat" * 5,
    b"xyz",
] * 2  # 16 records over 8 devices


@pytest.mark.parametrize("pattern", ["cat|dog", "(cat|dog)+", "c[a-u]*t"])
def test_global_stats_match_oracle(mesh, pattern):
    prog = compile_program(pattern)
    scanner = DistScanner(prog, mesh)
    oracle = OracleEngine(prog.nfa)

    data, lengths = _pack(RECORDS, 16, 32)
    d, l = shard_batch(mesh, data, lengths)
    total, nrec, nbytes = scanner.global_stats(d, l, seeded=True)

    exp_total = sum(len(oracle.ends(r)) for r in RECORDS)
    exp_nrec = sum(1 for r in RECORDS if oracle.search(r))
    assert int(total) == exp_total
    assert int(nrec) == exp_nrec
    assert int(nbytes) == sum(len(r) for r in RECORDS)


def test_per_record_sharding_and_values(mesh):
    prog = compile_program("(ab)*c+d?")
    scanner = DistScanner(prog, mesh)
    oracle = OracleEngine(prog.nfa)

    recs = [b"ababccd", b"c", b"abd", b"ababababc", b"ccc", b"", b"abc", b"d"] * 2
    data, lengths = _pack(recs, 16, 16)
    d, l = shard_batch(mesh, data, lengths)
    cnt, first, anym = scanner.per_record(d, l, seeded=True)
    # results stay sharded over the data axis (concrete array sharding;
    # jax.typeof's aval spec is unset under auto sharding on CPU meshes)
    assert "data" in str(cnt.sharding.spec)
    for i, r in enumerate(recs):
        ends = oracle.ends(r)
        assert int(np.asarray(cnt)[i]) == len(ends), (i, r)
        assert bool(np.asarray(anym)[i]) == oracle.search(r), (i, r)


def test_grep_hits(mesh):
    prog = compile_program("err(or)?")
    scanner = DistScanner(prog, mesh)
    recs = [b"no problem", b"error here", b"fine", b"an err", b"", b"ERROR",
            b"erro", b"xerrx"] * 2
    data, lengths = _pack(recs, 16, 16)
    d, l = shard_batch(mesh, data, lengths)
    hits = np.asarray(scanner.grep_hits(d, l))
    oracle = OracleEngine(prog.nfa)
    for i, r in enumerate(recs):
        assert bool(hits[i]) == oracle.search(r), (i, r)


@pytest.mark.parametrize("pattern", ["cat|dog", "ab(cd)+e", "(cat|dog)*"])
def test_long_string_sharded(mesh, pattern):
    """One long string sharded over the mesh must match the oracle."""
    from roaringregex.ops.longstring import LongScanner

    prog = compile_program(pattern)
    oracle = OracleEngine(prog.nfa)
    scanner = DistScanner(prog, mesh)
    text = (b"xxcatabcdcdcdedogyy" * 40)[:731]
    # sharded result == single-device block scanner == oracle
    cnt = scanner.long_count(text, block=32)
    assert cnt == len(oracle.ends(text)), pattern
    ls = LongScanner(prog, block=32)
    assert cnt == ls.count_ends(text)


def test_per_record_spans_sharded(mesh):
    """Sharded span extraction (lazy + greedy) matches the oracle."""
    prog = compile_program("(ab)+c?")
    scanner = DistScanner(prog, mesh)
    oracle = OracleEngine(prog.nfa)
    recs = [b"ababc", b"xxabx", b"", b"abab", b"cab", b"ababab", b"zz", b"ab"] * 2
    data, lengths = _pack(recs, 16, 16)
    d, l = shard_batch(mesh, data, lengths)
    for longest in (False, True):
        s_b, e_b, cnt_b, over = scanner.per_record_spans(
            d, l, cap=8, longest=longest
        )
        s_np, e_np, c_np = map(np.asarray, (s_b, e_b, cnt_b))
        assert not np.asarray(over).any()
        for i, rec in enumerate(recs):
            want = list(oracle.finditer(rec, longest=longest))
            got = list(zip(s_np[i, : c_np[i]].tolist(),
                           e_np[i, : c_np[i]].tolist()))
            assert got == want, (rec, longest, got, want)


def test_multipattern_sharded(mesh):
    """Accept-channel multi-pattern scan under the mesh."""
    from roaringregex.api import MultiPattern

    mp = MultiPattern(["err(or)?", "[0-9]{2}"])
    scanner = DistScanner(
        mp.program, mesh,
        accept_map=mp.accept_map,
        channels_per_record=mp.P, nullable=False,
    )
    recs = [b"error 42", b"err", b"12 fine", b"nothing"] * 4
    data, lengths = _pack(recs, 16, 16)
    d, l = shard_batch(mesh, data, lengths)
    _, _, any_pc = scanner.per_record(d, l, seeded=True)
    per = np.asarray(any_pc).reshape(-1, mp.P)
    from roaringregex.compiler.nfa import build_nfa
    for p, pat in enumerate(mp.patterns):
        o = OracleEngine(build_nfa(pat))
        for i, rec in enumerate(recs):
            assert bool(per[i, p]) == o.search(rec), (rec, pat)


def test_long_stats_sharded_kernel_rate(mesh):
    """Kernel-rate sharded long string: overlapped windows split over the
    data axis, one psum of (body, EOS-tail) — vs the oracle, plus the
    summary-SPMD fallback for cyclic patterns."""
    from roaringregex.utils.config import get_config, set_config

    base = get_config()
    rng = np.random.default_rng(23)
    t = bytes(rng.choice(list(b"abcdtogx"), size=6000).astype(np.uint8))
    try:
        set_config(base.with_(long_block=256))
        for pat in ("cat|dog", "ab?c"):
            prog = compile_program(pat)
            ds = DistScanner(prog, mesh)
            assert ds._long_fast_scanner() is not None
            orc = OracleEngine(prog.nfa)
            exp = len(orc.ends(t))
            assert ds.long_stats(t, mode="count") == exp, pat
            assert ds.long_stats(t, mode="any") == (exp > 0), pat
        # cyclic pattern: falls back to the summary SPMD path
        prog = compile_program("(ab)*c")
        ds = DistScanner(prog, mesh)
        assert ds._long_fast_scanner() is None
        orc = OracleEngine(prog.nfa)
        t2 = t[:800]
        assert ds.long_stats(t2, mode="count") == len(orc.ends(t2))
    finally:
        set_config(base)


def test_long_stats_sharded_counting(mesh):
    """Counting-plan patterns over ONE sharded long string: run-length
    windows split over the data axis, one psum — vs the oracle, including
    unbounded X{m,} (cyclic, no overlapped matrix mode) and windows that
    straddle device boundaries (tiny blocks)."""
    rng = np.random.default_rng(29)
    blobs = [
        (b"a" * 500 + b"x") * 4 + b"a" * 31,
        b"ab" * 1500,
        bytes(rng.choice(list(b"aabx"), 7000).astype(np.uint8)),
        b"a",
    ]
    for pat in ("a{1,300}", "(ab){2,600}", "a{3,}", "[ab]{2,9}"):
        ds = DistScanner(compile_program(pat), mesh)
        cls = ds._long_count_scanner()
        assert cls is not None, pat
        cls.block = 256  # force windows across all 8 devices
        orc = OracleEngine.compile(pat)
        for t in blobs:
            want = len(orc.ends(t))
            assert ds.long_stats(t, mode="count") == want, (pat, len(t))
            assert ds.long_stats(t, mode="any") == (want > 0), (pat, len(t))


def test_long_stream_sharded_placement(mesh):
    """The long-string stream is chunk-sharded, not replicated: each
    device holds C = ~n/D (block-granular) payload bytes plus the H-byte
    halo fetched by ppermute inside the SPMD program — asserted via the
    recorded placement geometry on all three sharded long paths."""
    D = mesh.devices.size
    t = bytes((np.arange(20000) % 26 + 97).astype(np.uint8))

    # overlapped-window path: per-device chunk = n/D plus at most one
    # packing group of G windows of <= block bytes
    ds = DistScanner(compile_program("cat|dog"), mesh)
    fls = ds._long_fast_scanner()
    assert fls is not None
    fls.block = 512
    G = ds.prog.G
    ds.long_stats(t, mode="count")
    C, H, shard_shape = ds.last_stream_geom
    assert int(np.prod(shard_shape)) == C
    assert C <= len(t) // D + G * fls.block, (C, H)
    # scaling: at 64 MB the chunk is ~n/D + one window group, not O(n)
    n_big = 64_000_000
    blk, npw, C2, H2 = ds._fls_geom(n_big, fls)
    assert C2 * D + H2 >= n_big + fls.overlap, "chunks must cover the stream"
    assert C2 <= n_big // D + G * blk, (C2, n_big // D)

    # counting-window path
    dc = DistScanner(compile_program("a{1,300}"), mesh)
    cls = dc._long_count_scanner()
    assert cls is not None
    cls.block = 256
    dc.long_stats(t, mode="count")
    C, H, shard_shape = dc.last_stream_geom
    assert shard_shape == (1, C)
    assert C <= len(t) // D + cls.block, (C, H)

    # summary+replay path (cyclic pattern): blocks sharded, no halo
    dr = DistScanner(compile_program("(ab)*c"), mesh)
    dr.long_count(t, block=512)
    C, H, shard_shape = dr.last_stream_geom
    assert H == 0 and int(np.prod(shard_shape)) == C
    assert C <= len(t) // D + 512, (C, shard_shape)


def test_long_stats_sharded_wide_tile(mesh):
    """Wide-tile (s_tile > 32) bounded-horizon patterns run the sharded
    overlapped-window path too."""
    for pat, blk in (("a{40}b{45}", 2560), ("a{140}b{150}", 4096)):
        ds = DistScanner(compile_program(pat), mesh)
        fls = ds._long_fast_scanner()
        assert fls is not None and fls.overlap is not None, pat
        fls.block = blk  # small windows so work crosses all devices
        orc = OracleEngine.compile(pat)
        t = (
            b"x" * 9000 + b"a" * 140 + b"b" * 150 + b"y" * 3000
            + b"a" * 40 + b"b" * 45 + b"z" * 2000
        )
        want = len(orc.ends(t))
        assert ds.long_stats(t, mode="count") == want, pat
        assert ds.long_stats(t, mode="any") == (want > 0), pat


def test_stats_stream_sharded(mesh):
    """DistScanner.stats_stream: chunked sharded streaming == the summed
    per-chunk global_stats; per-device placement is chunk/D rows."""
    from roaringregex.stream import StreamScanner

    prog = compile_program("cat|dog")
    ds = DistScanner(prog, mesh)
    rng = np.random.default_rng(3)
    chunks = []
    for _ in range(4):
        B, L = 24, 64  # deliberately not a multiple of 8 * G
        data = rng.integers(97, 123, size=(B, L), dtype=np.uint8)
        data[0, :3] = np.frombuffer(b"cat", np.uint8)
        lens = np.full(B, L, np.int32)
        chunks.append((data, lens))
    st = ds.stats_stream(iter(chunks), depth=2)
    assert st.chunks == 4
    assert st.records == 4 * 24
    assert st.bytes == sum(int(l.sum()) for _, l in chunks)
    # per-device rows = padded chunk rows / D
    G = max(1, prog.G)
    q = 8 * G
    Bp = -(-24 // q) * q
    assert ds.last_stream_shard_rows == Bp // 8
    # parity: single-device StreamScanner over the same chunks
    st1 = StreamScanner("cat|dog").stats_stream(iter(chunks))
    assert (st.matches, st.matched_records) == (
        st1.matches, st1.matched_records
    )
