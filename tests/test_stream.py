"""Out-of-core streaming (roaringregex/stream.py): the chunked
host->device pipeline must be exactly equivalent to one big batch, the
line batcher must reassemble records across read-chunk boundaries, and
the CLI --stream path must agree with grep semantics."""
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from roaringregex.compiler.program import compile_program  # noqa: E402
from roaringregex.engine import ScanEngine  # noqa: E402
from roaringregex.oracle.engine import OracleEngine  # noqa: E402
from roaringregex.stream import (  # noqa: E402
    StreamScanner,
    iter_line_batches,
    pack_records,
    stream_file_stats,
)


def _chunks(rng, n_chunks, B, L, plant=b"cat"):
    out = []
    for _ in range(n_chunks):
        data = rng.integers(97, 123, size=(B, L), dtype=np.uint8)
        for r in rng.integers(0, B, size=B // 4):
            c = int(rng.integers(0, L - len(plant)))
            data[r, c : c + len(plant)] = np.frombuffer(plant, np.uint8)
        lens = np.full(B, L, np.int32)
        lens[-1] = int(rng.integers(0, L))  # one ragged record per chunk
        out.append((data, lens))
    return out

def test_stats_stream_equals_batch():
    rng = np.random.default_rng(5)
    chunks = _chunks(rng, 5, 64, 128)
    sc = StreamScanner("cat|dog", depth=2)
    st = sc.stats_stream(iter(chunks))
    assert st.chunks == 5
    assert st.bytes == sum(int(l.sum()) for _, l in chunks)
    # reference: one engine pass per chunk, summed
    eng = ScanEngine(compile_program("cat|dog"))
    want_m = want_r = 0
    for d, l in chunks:
        cnt, _, anym = eng.match_stats(d, l, seeded=True)
        want_m += int(np.asarray(cnt).sum())
        want_r += int(np.asarray(anym).sum())
    assert st.matches == want_m
    assert st.matched_records == want_r


def test_hits_stream_order_and_parity():
    rng = np.random.default_rng(7)
    chunks = _chunks(rng, 4, 32, 64)
    sc = StreamScanner("cat|dog", depth=3)
    orc = OracleEngine.compile("cat|dog")
    seen = 0
    for (hits, data, lens), (d0, l0) in zip(
        sc.hits_stream(iter(chunks)), chunks
    ):
        assert np.array_equal(data, d0), "chunk order must be preserved"
        for i in range(d0.shape[0]):
            t = bytes(d0[i, : l0[i]])
            assert bool(hits[i]) == orc.search(t)
        seen += 1
    assert seen == 4


def test_iter_line_batches_reassembles_lines():
    rng = np.random.default_rng(9)
    lines = [
        bytes(rng.choice(list(b"abcxyz"), int(rng.integers(0, 200))))
        for _ in range(500)
    ]
    blob = b"\n".join(lines) + b"\n"
    got = []
    # tiny read chunks force many carry-over boundaries
    for data, lens, nreal in iter_line_batches(
        io.BytesIO(blob), rows=64, chunk_bytes=777
    ):
        assert data.shape[0] == 64
        for i in range(nreal):
            got.append(bytes(data[i, : lens[i]]))
    assert got == lines


def test_iter_line_batches_growing_width():
    blob = b"short\n" * 100 + b"x" * 5000 + b"\n" + b"tail\n"
    widths = set()
    got = []
    for data, lens, nreal in iter_line_batches(
        io.BytesIO(blob), rows=32, chunk_bytes=512, min_len=16
    ):
        widths.add(data.shape[1])
        got.extend(bytes(data[i, : lens[i]]) for i in range(nreal))
    assert max(widths) >= 8192  # grew past the long line
    assert got[-1] == b"tail" and got[-2] == b"x" * 5000
    assert len(got) == 102


def test_stream_file_stats_matches_grep():
    rng = np.random.default_rng(11)
    lines = []
    for _ in range(300):
        s = bytes(rng.choice(list(b"abcdefgh "), int(rng.integers(1, 80))))
        if rng.random() < 0.3:
            s += b"cat"
        lines.append(s)
    blob = b"\n".join(lines) + b"\n"
    st = stream_file_stats("cat|dog", io.BytesIO(blob), rows=64,
                           chunk_bytes=1024)
    orc = OracleEngine.compile("cat|dog")
    assert st.matched_records == sum(orc.search(ln) for ln in lines)


def test_cli_stream(tmp_path, capsys):
    from roaringregex.cli import main

    p = tmp_path / "corpus.txt"
    p.write_bytes(b"a cat here\nnothing\ndogs galore\n\ncat\n")
    rc = main(["cat|dog", str(p), "--stream", "-c"])
    assert rc == 0
    assert capsys.readouterr().out.strip() == "3"
    rc = main(["cat|dog", str(p), "--stream", "-n"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ["1:a cat here", "3:dogs galore", "5:cat"]
    rc = main(["zebra", str(p), "--stream", "-c"])
    assert rc == 1
    assert capsys.readouterr().out.strip() == "0"


def test_multipattern_stream():
    """StreamScanner over a MultiPattern: one combined-automaton pass per
    chunk, per-record hits = union over pattern channels (incl. a
    nullable channel, which hits every record)."""
    from roaringregex.api import MultiPattern
    from roaringregex.compiler.nfa import build_nfa

    rng = np.random.default_rng(13)
    chunks = _chunks(rng, 3, 32, 64, plant=b"cat")
    mp = MultiPattern(["cat|dog", "[0-9]{2}"])
    sc = StreamScanner(mp, depth=2)
    orcs = [OracleEngine(build_nfa(p)) for p in mp.patterns]
    for (hits, data, lens), (d0, l0) in zip(
        sc.hits_stream(iter(chunks)), chunks
    ):
        for i in range(d0.shape[0]):
            t = bytes(d0[i, : l0[i]])
            want = any(o.search(t) for o in orcs)
            assert bool(hits[i]) == want, t
    st = sc.stats_stream(iter(chunks))
    assert st.chunks == 3
    # nullable channel: every line (and phantom) hits
    mp2 = MultiPattern(["zz", "a*"])
    sc2 = StreamScanner(mp2, depth=2)
    for hits, data, lens in sc2.hits_stream(iter(chunks[:1])):
        assert hits.all()


def test_cli_stream_multipattern(tmp_path, capsys):
    from roaringregex.cli import main

    p = tmp_path / "c.txt"
    p.write_bytes(b"a cat\nnothing here\n42 wide\n")
    rc = main(["-e", "cat|dog", "-e", "[0-9]{2}", str(p), "--stream", "-c"])
    assert rc == 0
    assert capsys.readouterr().out.strip() == "2"


def test_stats_stream_nullable_padding_exact():
    """Phantom pad rows must not count as matches/records for nullable
    patterns (single- and multi-pattern), and nullable channels must get
    the exact empty-match counts (len + 1 per real record)."""
    from roaringregex.api import MultiPattern
    from roaringregex.stream import stream_file_stats

    st = stream_file_stats("a*", io.BytesIO(b"aa\nb\n\n"), rows=64,
                           chunk_bytes=64)
    # ends per record: 'aa' -> 3, 'b' -> 1 (empty match positions 0,1 and
    # ... a* on 'b': ends {0,1}) wait oracle: len+1 = 2; '' -> 1
    from roaringregex.oracle.engine import OracleEngine
    orc = OracleEngine.compile("a*")
    want = sum(len(orc.ends(t)) for t in [b"aa", b"b", b""])
    assert st.matches == want
    assert st.matched_records == 3
    assert st.records == 3

    mp = MultiPattern(["a*", "b"])
    sc = StreamScanner(mp, depth=2)
    data, lens = pack_records([b"aa", b"b", b""], 3, 16)
    st2 = sc.stats_stream([(data, lens, 3)])
    orc_b = OracleEngine.compile("b")
    want2 = want + sum(len(orc_b.ends(t)) for t in [b"aa", b"b", b""])
    assert st2.matches == want2
    assert st2.matched_records == 3
    # G-misaligned chunks pad internally instead of crashing
    st3 = sc.stats_stream([(data, lens)])
    assert st3.matches == want2


def test_stream_single_nullable_multipattern():
    """MultiPattern(['a*']) (P == 1 but the engine runs nullable=False):
    stats and hits must apply the channel correction, not the
    native-nullable-engine one."""
    from roaringregex.api import MultiPattern
    from roaringregex.oracle.engine import OracleEngine

    orc = OracleEngine.compile("a*")
    data, lens = pack_records([b"aa", b"b", b""], 3, 16)
    sc = StreamScanner(MultiPattern(["a*"]), depth=2)
    st = sc.stats_stream([(data, lens, 3)])
    want = sum(len(orc.ends(t)) for t in [b"aa", b"b", b""])
    assert (st.matches, st.matched_records, st.records) == (want, 3, 3)
    hits, _, _ = next(iter(sc.hits_stream([(data, lens, 3)])))
    assert hits[:3].all()


def test_stream_raw_engine_gates():
    """A raw multi-channel engine with a nullable pattern is rejected
    (per-channel nullability unrecoverable); non-nullable multi engines
    and plain single-pattern engines work."""
    from roaringregex.api import MultiPattern

    with pytest.raises(ValueError):
        StreamScanner(MultiPattern(["a*", "b"]).engine)
    data, lens = pack_records([b"aa", b"b", b""], 3, 16)
    st = StreamScanner(MultiPattern(["ab", "b"]).engine).stats_stream(
        [(data, lens, 3)]
    )
    assert st.matches == 1  # only 'b' in b"b"


def test_pack_records_truncates():
    data, lens = pack_records([b"abc", b"x" * 50], 4, 16)
    assert lens.tolist() == [3, 16, 0, 0]
    assert bytes(data[1, :16]) == b"x" * 16


def test_spans_stream_parity():
    """spans_stream: per-chunk device span extraction == finditer_batch,
    overflow flagged exactly (never silently truncated)."""
    rng = np.random.default_rng(11)
    chunks = _chunks(rng, 3, 32, 96)
    sc = StreamScanner("cat|dog", depth=2, backend="pallas")
    from roaringregex.api import Pattern

    p = Pattern("cat|dog")
    for s_b, e_b, c_b, over, data, lens in sc.spans_stream(
        iter(chunks), cap=8
    ):
        texts = [bytes(data[i, : lens[i]]) for i in range(len(lens))]
        want = p.finditer_batch(texts)
        for i, w in enumerate(want):
            if over[i]:
                assert int(c_b[i]) == len(w)
                continue
            got = list(zip(s_b[i, : c_b[i]].tolist(), e_b[i, : c_b[i]].tolist()))
            assert got == w, i
    # greedy policy
    for s_b, e_b, c_b, over, data, lens in sc.spans_stream(
        iter(chunks[:1]), cap=8, longest=True
    ):
        texts = [bytes(data[i, : lens[i]]) for i in range(len(lens))]
        want = p.finditer_batch(texts, longest=True)
        for i, w in enumerate(want):
            if not over[i]:
                got = list(
                    zip(s_b[i, : c_b[i]].tolist(), e_b[i, : c_b[i]].tolist())
                )
                assert got == w, i
    # tiny cap: overflow counters fire, counts stay exact
    n_over = 0
    for s_b, e_b, c_b, over, data, lens in sc.spans_stream(
        iter(chunks), cap=1
    ):
        texts = [bytes(data[i, : lens[i]]) for i in range(len(lens))]
        want = p.finditer_batch(texts)
        for i, w in enumerate(want):
            assert int(c_b[i]) == len(w)
            n_over += bool(over[i])
    assert n_over > 0
    # nullable patterns raise cleanly
    with pytest.raises(ValueError):
        list(
            StreamScanner("a*", backend="pallas").spans_stream(
                iter(chunks[:1])
            )
        )


def test_cli_stream_spans(tmp_path, capsys):
    from roaringregex.cli import main

    f = tmp_path / "t.txt"
    f.write_bytes(b"the cat sat\nno match\ndog dog\n")
    rc = main(["cat|dog", str(f), "--stream", "-o", "--backend", "pallas"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert out == ["4-7", "0-3 4-7"]


def test_spans_stream_sparse_bitband():
    """Out-of-core span extraction on a >256-state (forced-sparse)
    pattern: spans_stream -> engine.spans (prefilter compaction) -> XLA
    anchored span rounds, all inside the chunk jit."""
    from roaringregex.utils.config import get_config, set_config

    base = get_config()
    try:
        set_config(base.with_(dense_max=256, seeded_alias=False))
        pat = "x(ab|c){100,120}y"
        hit = b"x" + b"ab" * 20 + b"c" * 85 + b"y"  # 105 copies
        eng = ScanEngine(compile_program(pat), backend="pallas")
        assert eng.backend == "xla" and eng.device_spans
        sc = StreamScanner(eng, depth=2)
        rng = np.random.default_rng(13)
        chunks = []
        for k in range(2):
            B, L = 24, 256
            data = rng.integers(97, 123, size=(B, L), dtype=np.uint8)
            data[3, 10 : 10 + len(hit)] = np.frombuffer(hit, np.uint8)
            lens = np.full(B, L, np.int32)
            chunks.append((data, lens))
        orc = OracleEngine(eng.prog.nfa)
        n_hits = 0
        for s_b, e_b, c_b, over, data, lens in sc.spans_stream(
            iter(chunks), cap=4
        ):
            assert not over.any()
            for i in range(len(lens)):
                t = bytes(data[i, : lens[i]])
                want = orc.findall(t)
                got = list(zip(
                    s_b[i, : c_b[i]].tolist(), e_b[i, : c_b[i]].tolist()
                ))
                assert got == want, i
                n_hits += len(want)
        assert n_hits >= 2
    finally:
        set_config(base)
