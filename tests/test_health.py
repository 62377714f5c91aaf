"""Failure detection / elastic recovery (parallel.health) on the virtual
8-device CPU mesh.

The reference has no failure story at all (single process, SURVEY.md §5);
this covers the beyond-fail-fast tier: active mesh probing, retry wrappers,
remeshing over survivors, and the full detect -> remesh -> retry drill via
fault injection.
"""
import numpy as np
import pytest

import jax

from roaringregex.compiler.program import compile_program
from roaringregex.oracle.engine import OracleEngine
from roaringregex.parallel import (
    DistScanner,
    ElasticScanner,
    InjectedFault,
    inject_faults,
    make_mesh,
    probe_mesh,
    shard_batch,
    surviving_mesh,
    with_retry,
)


def _pack(records, L_pad=32):
    data = np.zeros((len(records), L_pad), dtype=np.uint8)
    lengths = np.zeros(len(records), dtype=np.int32)
    for i, r in enumerate(records):
        data[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
        lengths[i] = len(r)
    return data, lengths


RECORDS = [
    b"catdog", b"dog", b"bird", b"catcatcat", b"", b"cccatdoggg",
    b"dogcat" * 4, b"xyz", b"cat", b"ccccdddd", b"adogb", b"catx",
] * 2  # 24 records


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8
    return make_mesh(8)


def test_probe_mesh_healthy(mesh):
    h = probe_mesh(mesh, timeout_s=60.0)
    assert h.ok, h
    assert len(h.alive) == 8 and not h.dead
    assert h.latency_s > 0


def test_surviving_mesh_shrinks(mesh):
    h = probe_mesh(mesh, collective=False, timeout_s=60.0)
    m6 = surviving_mesh(h.alive[:6])
    assert int(np.prod(m6.devices.shape)) == 6
    m4 = surviving_mesh(h.alive[:6], pow2=True)
    assert int(np.prod(m4.devices.shape)) == 4
    with pytest.raises(RuntimeError):
        surviving_mesh([])


def test_with_retry_transient():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("transient")
        return 42

    assert with_retry(flaky, retries=3, backoff_s=0.0) == 42
    assert len(calls) == 3
    with pytest.raises(ValueError):
        with_retry(flaky_always := (lambda: (_ for _ in ()).throw(
            ValueError("hard"))), retries=1, backoff_s=0.0)


def test_elastic_matches_dist(mesh):
    prog = compile_program("cat|dog")
    oracle = OracleEngine(prog.nfa)
    data, lengths = _pack(RECORDS)
    es = ElasticScanner(prog, mesh)
    total, nrec, nbytes = es.global_stats(data, lengths)

    sc = DistScanner(prog, mesh)
    d, l = shard_batch(mesh, data, lengths)
    t2, n2, b2 = sc.global_stats(d, l)
    assert int(total) == int(t2) and int(nrec) == int(n2)
    assert int(nbytes) == int(b2)

    want = sum(len(oracle.ends(bytes(r))) for r in RECORDS)
    assert int(total) == want

    hits = es.grep_hits(data, lengths)
    assert hits.shape[0] == len(RECORDS)
    for i, r in enumerate(RECORDS):
        assert bool(hits[i]) == (len(oracle.ends(bytes(r))) > 0), (i, r)


def test_elastic_recovers_from_injected_fault(mesh):
    """The full drill: armed fault -> probe -> rebuild -> retry succeeds,
    and results are identical to the healthy run."""
    prog = compile_program("cat|dog")
    data, lengths = _pack(RECORDS)
    es = ElasticScanner(prog, mesh, probe_timeout_s=60.0)
    healthy = tuple(int(x) for x in es.global_stats(data, lengths))

    inject_faults(1)
    recovered = tuple(int(x) for x in es.global_stats(data, lengths))
    assert recovered == healthy
    assert es.recoveries == 1

    # odd batch size still pads correctly after recovery
    cnt, first, anym = es.per_record(data[:23], lengths[:23])
    assert cnt.shape[0] == 23

    # exhausting max_recoveries re-raises the fault
    es2 = ElasticScanner(prog, mesh, max_recoveries=0)
    inject_faults(1)
    with pytest.raises(InjectedFault):
        es2.global_stats(data, lengths)
    inject_faults(0)


def test_elastic_recovers_span_extraction(mesh):
    """Fault drill mid-span-extraction: remesh + replay must reproduce the
    oracle spans exactly (VERDICT r3 #9: elastic coverage beyond stats)."""
    prog = compile_program("(ab)+c?")
    oracle = OracleEngine(prog.nfa)
    recs = [b"ababc", b"xxabx", b"", b"abab", b"cab", b"ababab", b"zz",
            b"ab"] * 2
    data, lengths = _pack(recs)
    es = ElasticScanner(prog, mesh, probe_timeout_s=60.0)
    for longest in (False, True):
        inject_faults(1)
        s, e, cnt, over = es.per_record_spans(
            data, lengths, cap=8, longest=longest
        )
        assert not over.any()
        for i, rec in enumerate(recs):
            want = list(oracle.finditer(rec, longest=longest))
            got = list(zip(s[i, : cnt[i]].tolist(), e[i, : cnt[i]].tolist()))
            assert got == want, (rec, longest)
    assert es.recoveries == 2
    inject_faults(0)


def test_elastic_recovers_long_string(mesh):
    """Fault drill mid-long-string scan: the sharded stream is rebuilt on
    the surviving mesh from host bytes and replayed."""
    prog = compile_program("cat|dog")
    oracle = OracleEngine(prog.nfa)
    blob = (b"x" * 300 + b"catdog7" + b"y" * 400) * 3
    es = ElasticScanner(prog, mesh, probe_timeout_s=60.0)
    want = len(oracle.ends(blob))
    inject_faults(1)
    assert es.long_stats(blob, mode="count") == want
    assert es.recoveries == 1
    inject_faults(1)
    assert es.long_count(blob, block=256) == want
    assert es.recoveries == 2
    inject_faults(0)


def test_elastic_global_stats_nullable_padding(mesh):
    """Zero-length phantom records appended by _pad_to_mesh must not count:
    for a nullable pattern each phantom would otherwise add one empty match
    and one matched record to the psum totals."""
    prog = compile_program("a*")  # nullable: empty record matches
    oracle = OracleEngine(prog.nfa)
    recs = [b"aaa", b"bbb", b"a"]  # 3 records on an 8-device mesh -> 5 pads
    data, lengths = _pack(recs)
    es = ElasticScanner(prog, mesh)
    total, nrec, nbytes = es.global_stats(data, lengths)

    want_total = sum(len(oracle.ends(bytes(r))) for r in recs)
    want_nrec = sum(1 for r in recs if len(oracle.ends(bytes(r))) > 0)
    assert int(total) == want_total
    assert int(nrec) == want_nrec
    assert int(nbytes) == sum(len(r) for r in recs)
