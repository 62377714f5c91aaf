#!/usr/bin/env python3
"""Smoke run of the scanner's main path on one NVIDIA GPU.

Drives the public entry points once at real sizes, on data generated from
``--seed``, and checks every result exactly against two independent
implementations: the native host engine (native/rrx_host.cc) on the full
data and the Python oracle (oracle/engine.py) on a sample.

Phases:

  a. ``pytest -m gpu`` in a subprocess, before this process touches JAX
     (one process holds the card at a time);
  b. the card's name and power limit, the JAX version, the native build;
  c. batch scans (Pattern count/search/finditer lazy+greedy,
     MultiPattern.search_batch) over 64 MiB of 1 KiB records, and the
     >1024-state tier over 4 MiB;
  d. one 128 MiB string: Pattern.long.count_ends and finditer_long for a
     horizon-bounded and a cyclic pattern;
  e. stream_file_stats and the CLI ``--stream -c`` over a 1 GiB file;
  f. the word kernel against the packed engine: exact equality and time;
  g. per phase, ``compiled.memory_analysis()`` of its step and its rate.

Usage:
    python3 chip_smoke.py [--seed N]      # one GPU
    python3 chip_smoke.py --mesh 4        # DistScanner on four GPUs only
    JAX_PLATFORMS=cpu python3 chip_smoke.py --rehearse   # tiny, on CPU

The last line of stdout is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
A run without a GPU (and without --rehearse) exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, flush=True)


def die(msg: str, code: int = 2):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check(cond, *what):
    """Fail the run (a mismatch is never skipped, even under -O)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# Set-up that must not touch JAX
# ---------------------------------------------------------------------------


def check_checkout():
    for rel in ("roaringregex/__init__.py", "tests/conftest.py",
                "native/rrx_host.cc"):
        if not os.path.exists(os.path.join(HERE, rel)):
            die(f"{rel} not found next to chip_smoke.py: run it from a "
                "checkout of the repository")
    sys.path.insert(0, HERE)


def nvidia_smi_lines():
    """Lines of ``nvidia-smi --query-gpu=name,power.limit``; [] without
    a card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    r = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        return []
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def phase_a_gpu_tests():
    """``pytest -m gpu`` in a subprocess: every gpu test must run and
    pass (none may skip)."""
    t0 = time.perf_counter()
    junit = os.path.join(HERE, ".smoke_data", "gpu_tests.xml")
    os.makedirs(os.path.dirname(junit), exist_ok=True)
    env = dict(os.environ, RRX_TEST_GPU="1")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-rs",
         f"--junitxml={junit}"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = "\n".join(r.stdout.strip().splitlines()[-5:])
    import xml.etree.ElementTree as ET

    suite = ET.parse(junit).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n = int(suite.get("tests"))
    bad = sum(int(suite.get(k)) for k in ("failures", "errors", "skipped"))
    log(f"phase a: pytest -m gpu rc={r.returncode} tests={n} "
        f"failed/errored/skipped={bad} ({time.perf_counter() - t0:.1f} s)")
    log("  " + tail.replace("\n", "\n  "))
    check(r.returncode == 0 and n > 0 and bad == 0, "gpu tests failed")


# ---------------------------------------------------------------------------
# Data (numpy only, from the seed)
# ---------------------------------------------------------------------------


def make_records(rng, n_bytes: int, rec_len: int = 1024):
    """[B, rec_len] lowercase records with planted matches for every
    smoke pattern; 1/8 of the records are shorter than rec_len."""
    import numpy as np

    B = max(1, n_bytes // rec_len)
    data = rng.integers(ord("a"), ord("z") + 1, size=(B, rec_len),
                        dtype=np.uint8)
    lens = np.full(B, rec_len, np.int32)
    short = rng.random(B) < 0.125
    lens[short] = rng.integers(0, rec_len, size=int(short.sum()))
    for word, frac in ((b"cat", 0.125), (b"dog", 0.125), (b"123", 0.05),
                       (b"error", 0.05), (b"abcdcde", 0.05),
                       (b"ababccd", 0.05)):
        w = np.frombuffer(word, np.uint8)
        rows = rng.integers(0, B, size=max(1, int(B * frac)))
        cols = rng.integers(0, rec_len - len(w), size=rows.size)
        for r_, c_ in zip(rows, cols):
            data[r_, c_ : c_ + len(w)] = w
    # records ending in ".log" for the $-anchored pattern
    rows = rng.integers(0, B, size=max(1, B // 16))
    for r_ in rows:
        L = int(lens[r_])
        if L >= 8:
            data[r_, L - 4 : L] = np.frombuffer(b".log", np.uint8)
    return data, lens


def as_texts(data, lens):
    return [bytes(data[i, : lens[i]]) for i in range(len(lens))]


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------


def median_time(fn, reps: int = 3):
    """Median wall time of ``fn()`` (which blocks on its result), after
    one untimed call that compiles."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def memory_line(name, fn, *args):
    """``compiled.memory_analysis()`` of jit(fn) at these arguments."""
    import jax

    ma = jax.jit(fn).lower(*args).compile().memory_analysis()
    if ma is None:
        log(f"  memory[{name}]: not reported by this backend")
        return
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    vals = ", ".join(f"{f.replace('_size_in_bytes', '')}="
                     f"{getattr(ma, f, 'n/a')}" for f in fields)
    log(f"  memory[{name}]: {vals}")


def rate(nbytes: int, s: float) -> str:
    return f"{nbytes / s / 1e9:.3f} GB/s ({s * 1e3:.1f} ms for {nbytes} B)"


def sample_idx(rng, B: int, k: int):
    import numpy as np

    return np.sort(rng.choice(B, size=min(k, B), replace=False))


def _oracle_job(args):
    """Worker: the oracle's (count, lazy spans, greedy spans) per text."""
    pattern, texts, spans = args
    sys.path.insert(0, HERE)
    from roaringregex.oracle.engine import OracleEngine

    o = OracleEngine.compile(pattern)
    return [
        (len(o.ends(t)),
         o.findall(t) if spans else None,
         o.findall(t, longest=True) if spans else None)
        for t in texts
    ]


def oracle_results(pool, pattern, texts, spans=True):
    """The oracle over ``texts`` on the host's cores (worker processes
    never touch JAX or the card)."""
    n = max(1, min(pool._max_workers, len(texts)))
    parts = list(pool.map(
        _oracle_job, [(pattern, texts[i::n], spans) for i in range(n)]
    ))
    out = [None] * len(texts)
    for i in range(n):
        out[i::n] = parts[i]
    return out


# ---------------------------------------------------------------------------
# Phase c: batch scans
# ---------------------------------------------------------------------------


def check_pattern_batch(pool, pat_str, data, lens, rng, n_sample, tag):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from roaringregex import Pattern
    from roaringregex.compiler.native import HostEngine

    texts = as_texts(data, lens)
    nbytes = int(lens.sum())
    p = Pattern(pat_str)
    host = HostEngine(pat_str)
    t0 = time.perf_counter()
    cnt = np.asarray(p.count_batch(texts))
    t_cnt = time.perf_counter() - t0
    hit = np.asarray(p.search_batch(texts))
    t0 = time.perf_counter()
    lazy = p.finditer_batch(texts)
    t_lazy = time.perf_counter() - t0
    greedy = p.finditer_batch(texts, longest=True)
    for i, t in enumerate(texts):
        h = host.count_ends(t)
        check(int(cnt[i]) == h, tag, pat_str, "count", i, int(cnt[i]), h)
        check(bool(hit[i]) == (h > 0), tag, pat_str, "search", i)
        check(lazy[i] == host.finditer(t), tag, pat_str, "lazy", i)
        check(greedy[i] == host.finditer(t, longest=True),
              tag, pat_str, "greedy", i)
    idx = sample_idx(rng, len(texts), n_sample)
    for i, (oc, ol, og) in zip(idx, oracle_results(
            pool, pat_str, [texts[i] for i in idx])):
        check(int(cnt[i]) == oc, tag, pat_str, "oracle", i)
        check(lazy[i] == ol, tag, pat_str, "oracle lazy", i)
        check(greedy[i] == og, tag, pat_str, "oracle greedy", i)
    eng = p.engine
    d, l = jnp.asarray(data), jnp.asarray(lens)
    step = lambda d, l: eng.match_stats(d, l, seeded=True)  # noqa: E731
    t_dev = median_time(lambda: jax.block_until_ready(step(d, l)))
    log(f"  [{tag}] {pat_str!r} route={tuple(eng.route)} "
        f"matches={int(cnt.sum())} spans={sum(map(len, lazy))}: exact vs "
        f"host ({len(texts)} recs) and oracle ({n_sample} recs)")
    log(f"    first calls (compile included): count_batch "
        f"{rate(nbytes, t_cnt)}, finditer lazy {rate(nbytes, t_lazy)}; "
        f"warm device match_stats {rate(nbytes, t_dev)}")
    memory_line(f"{tag} {pat_str} match_stats", step, d, l)


def phase_c(pool, rng, mib: int, sparse_mib: int, n_sample: int):
    import numpy as np

    from roaringregex import MultiPattern
    from roaringregex.compiler.native import HostEngine
    from roaringregex.oracle.engine import OracleEngine

    t0 = time.perf_counter()
    data, lens = make_records(rng, mib << 20)
    log(f"phase c: batch scans over {len(lens)} records "
        f"({int(lens.sum())} B)")
    for pat in ("cat|dog", "[a-z]+\\.log$", "(ab)*c+d?", "a{1,300}"):
        check_pattern_batch(pool, pat, data, lens, rng, n_sample, "c")
    pats = ["cat|dog", "[0-9]{3}", "err(or)?", "ab(cd)*e"]
    mp = MultiPattern(pats)
    texts = as_texts(data, lens)
    t1 = time.perf_counter()
    got = np.asarray(mp.search_batch(texts))
    t_mp = time.perf_counter() - t1
    for j, ps in enumerate(pats):
        host = HostEngine(ps)
        want = np.array([host.search(t) for t in texts])
        check((got[:, j] == want).all(), "c multi", ps)
        orc = OracleEngine.compile(ps)
        for i in sample_idx(rng, len(texts), n_sample):
            check(bool(got[i, j]) == bool(orc.ends(texts[i])),
                  "c multi", ps, i)
    log(f"  [c] MultiPattern x{len(pats)} route={tuple(mp.engine.route)}: "
        f"exact; search_batch first call {rate(int(lens.sum()), t_mp)}")
    # >1024-state tier: the x...y context blocks the seeded alias and the
    # counting plan, so the full-width scan (behind the prefilter) runs
    sdata, slens = make_records(rng, sparse_mib << 20)
    hit = np.frombuffer(b"x" + b"ab" * 200 + b"c" * 210 + b"y", np.uint8)
    for r_ in rng.integers(0, len(slens), size=max(2, len(slens) // 64)):
        slens[r_] = 1024
        sdata[r_, 100 : 100 + len(hit)] = hit
    check_pattern_batch(
        pool, "x(ab|c){400,520}y", sdata, slens, rng, n_sample, "c"
    )
    log(f"phase c done ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# Phase d: one long string
# ---------------------------------------------------------------------------


def phase_d(rng, mib: int, prefix: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from roaringregex import Pattern
    from roaringregex.compiler.native import HostEngine
    from roaringregex.oracle.engine import OracleEngine

    t0 = time.perf_counter()
    n = mib << 20
    blob = rng.integers(ord("a"), ord("z") + 1, size=n, dtype=np.uint8)
    for word in (b"cat", b"dog", b"qababz", b"qz"):
        w = np.frombuffer(word, np.uint8)
        for c_ in rng.integers(0, n - len(w), size=max(1, n >> 16)):
            blob[c_ : c_ + len(w)] = w
    text = blob.tobytes()
    d = jnp.asarray(blob)
    log(f"phase d: one {n}-byte string")
    for pat_str in ("cat|dog", "q(ab)*z"):
        p = Pattern(pat_str)
        sc = p.long
        host = HostEngine(pat_str)
        cnt = sc.count_ends(d)
        want = host.count_ends(text)
        check(cnt == want, "d count", pat_str, cnt, want)
        t_cnt = median_time(
            lambda: jax.block_until_ready(sc._run(d, True, "count")))
        t1 = time.perf_counter()
        spans = p.finditer_long(text)
        t_sp = time.perf_counter() - t1
        check(spans == host.finditer(text), "d finditer_long", pat_str)
        orc = OracleEngine(p.program.nfa)
        head, short = text[:prefix], text[: prefix // 16]
        check(sc.count_ends(head) == len(orc.ends(head)), "d oracle", pat_str)
        check(p.finditer_long(short) == orc.findall(short),
              "d oracle spans", pat_str)
        log(f"  [d] {pat_str!r} {type(sc).__name__} "
            f"windows={getattr(sc, 'overlap', None) is not None}: "
            f"count={cnt} spans={len(spans)} exact vs host and oracle "
            f"(count on a {len(head)} B prefix, spans on {len(short)} B)")
        log(f"    warm count_ends {rate(n, t_cnt)}; finditer_long first "
            f"call {rate(n, t_sp)}")
        memory_line(f"d {pat_str} count", lambda x: sc._run(x, True, "count"),
                    d)
    log(f"phase d done ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# Phase e: streamed file
# ---------------------------------------------------------------------------


def phase_e(rng, mib: int, n_sample: int):
    import numpy as np

    from roaringregex.cli import main as cli_main
    from roaringregex.compiler.native import HostEngine
    from roaringregex.oracle.engine import OracleEngine
    from roaringregex.stream import StreamScanner, iter_line_batches

    t0 = time.perf_counter()
    n = mib << 20
    buf = rng.integers(ord("a"), ord("z") + 1, size=n, dtype=np.uint8)
    # newline-delimited lines of 16..240 bytes
    pos = np.cumsum(rng.integers(16, 240, size=n // 16))
    buf[pos[pos < n]] = ord("\n")
    buf[-1] = ord("\n")
    for word in (b"cat", b"dog"):
        w = np.frombuffer(word, np.uint8)
        for c_ in rng.integers(0, n - 4, size=n >> 12):
            if not (buf[c_ : c_ + 3] == ord("\n")).any():
                buf[c_ : c_ + 3] = w
    path = os.path.join(HERE, ".smoke_data", "stream.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf.tofile(path)
    raw = buf.tobytes()
    del buf
    pat = "cat|dog"
    log(f"phase e: {n}-byte newline-delimited file")
    try:
        host = HostEngine(pat)
        want_lines = int(host.grep_lines(raw).sum())
        want_matches = host.count_ends(raw)
        n_lines = raw.count(b"\n")
        sc = StreamScanner(pat)
        t1 = time.perf_counter()
        with open(path, "rb") as f:
            st = sc.stats_stream(iter_line_batches(f))
        t_st = time.perf_counter() - t1
        check(st.matched_records == want_lines, st, want_lines)
        check(st.matches == want_matches, st, want_matches)
        check(st.records == n_lines and st.bytes == n - n_lines, st)
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main([pat, path, "--stream", "-c"])
        t_cli = time.perf_counter() - t1
        check(rc == 0 and int(out.getvalue().split()[-1]) == want_lines,
              rc, out.getvalue()[-200:])
        lines = raw.split(b"\n")
        orc = OracleEngine.compile(pat)
        hits = host.grep_lines(raw)
        for i in sample_idx(rng, n_lines, n_sample):
            check(bool(hits[i]) == bool(orc.ends(lines[i])), "e oracle", i)
        log(f"  [e] stream_file_stats matches={st.matches} "
            f"lines={st.matched_records}/{st.records} chunks={st.chunks}: "
            f"exact vs host and oracle ({n_sample} lines)")
        log(f"    stream_file_stats first call {rate(n, t_st)}; CLI "
            f"--stream -c {rate(n, t_cli)}")
        d, l, _ = next(iter_line_batches(io.BytesIO(raw[: 64 << 20])))
        memory_line("e stream chunk", sc._stats_fn(), d, l)
    finally:
        os.remove(path)
    log(f"phase e done ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# Phase f: word kernel vs packed engine
# ---------------------------------------------------------------------------


def phase_f(rng, mib: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from roaringregex import MultiPattern, Pattern

    data, lens = make_records(rng, mib << 20)
    texts = as_texts(data, lens)
    nbytes = int(lens.sum())
    d, l = jnp.asarray(data), jnp.asarray(lens)
    log(f"phase f: word kernel vs packed, {len(texts)} records ({nbytes} B)")
    cases = [
        ("cat|dog", lambda b: Pattern("cat|dog", backend=b)),
        ("[a-z]+\\.log$", lambda b: Pattern("[a-z]+\\.log$", backend=b)),
        ("multi x4", lambda b: MultiPattern(
            ["cat|dog", "[0-9]{3}", "err(or)?", "ab(cd)*e"], backend=b)),
    ]
    results = {}
    for name, mk in cases:
        row = {}
        outs = {}
        for backend in ("pallas", "packed"):
            p = mk(backend)
            eng = p.engine
            if backend == "pallas":
                check(eng.route.kernel == "word", name, eng.route)
            outs[backend] = np.asarray(p.count_batch(texts))
            t_e2e = median_time(lambda: p.count_batch(texts), reps=5)
            # host arrays in, host counts out: upload + scan + fetch,
            # without count_batch's Python record packing
            t_host = median_time(lambda: np.asarray(
                eng.match_stats(data, lens, seeded=True)[0]), reps=5)
            step = lambda d, l: eng.match_stats(d, l, seeded=True)  # noqa
            t_dev = median_time(
                lambda: jax.block_until_ready(step(d, l)), reps=5)
            row[backend] = (t_e2e, t_host, t_dev)
            log(f"  [f] {name} {backend:6s}: count_batch {rate(nbytes, t_e2e)}"
                f"; from host arrays {rate(nbytes, t_host)}; device "
                f"match_stats {rate(nbytes, t_dev)}")
            memory_line(f"f {name} {backend}", step, d, l)
        check((outs["pallas"] == outs["packed"]).all(), "f parity", name)
        results[name] = row
        win = min(row, key=lambda k: row[k][1])
        log(f"  [f] {name}: exact; faster from host arrays: {win}")
    return results


# ---------------------------------------------------------------------------
# Mesh: DistScanner on four cards
# ---------------------------------------------------------------------------


def phase_mesh(pool, rng, n_dev: int, mib_per_dev: int, n_sample: int):
    import jax
    import numpy as np

    from roaringregex.compiler.program import compile_program
    from roaringregex.engine import ScanEngine
    from roaringregex.oracle.engine import OracleEngine
    from roaringregex.parallel import DistScanner, make_mesh, shard_batch

    check(len(jax.devices()) >= n_dev, jax.devices(), n_dev)
    mesh = make_mesh(n_dev)
    data, lens = make_records(rng, n_dev * (mib_per_dev << 20))
    B = (len(lens) // n_dev) * n_dev
    data, lens = data[:B], lens[:B]
    nbytes = int(lens.sum())
    log(f"phase mesh: DistScanner over {n_dev} devices, {B} records "
        f"({nbytes} B)")
    pat = "cat|dog"
    prog = compile_program(pat)
    ds = DistScanner(prog, mesh)
    ref = ScanEngine(prog)
    orc = OracleEngine(prog.nfa)
    texts = as_texts(data, lens)
    sample = sample_idx(rng, B, n_sample)
    d, l = shard_batch(mesh, data, lens)
    # one-card reference on the same data
    r_cnt, r_first, r_any = (np.asarray(x) for x in ref.match_stats(
        data, lens, seeded=True))
    step = jax.jit(ds.global_stats, static_argnames=("seeded",))
    total, nrec, nb = (int(x) for x in step(d, l, seeded=True))
    check((total, nrec, nb) == (int(r_cnt.sum()), int(r_any.sum()), nbytes))
    t = median_time(lambda: jax.block_until_ready(step(d, l, seeded=True)))
    log(f"  [mesh] global_stats matches={total} records={nrec}: equal to "
        f"one card; {rate(nbytes, t)}")
    memory_line("mesh global_stats", lambda d, l: ds.global_stats(d, l), d, l)
    hits = np.asarray(ds.grep_hits(d, l))
    check((hits == r_any).all())
    oracle = oracle_results(pool, pat, [texts[i] for i in sample])
    for i, (oc, _, _) in zip(sample, oracle):
        check(bool(hits[i]) == (oc > 0), "mesh grep", i)
    log("  [mesh] grep_hits: equal to one card and oracle")
    cap = int(2 ** np.ceil(np.log2(max(int(r_cnt.max()), 1))))
    s_b, e_b, c_b, over = (np.asarray(x) for x in ds.per_record_spans(
        d, l, cap=cap))
    check(not over.any())
    r_s, r_e, r_c, _ = (np.asarray(x) for x in ref.spans(data, lens, cap=cap))
    check((c_b == r_c).all() and (s_b == r_s).all() and (e_b == r_e).all())
    for i, (_, ol, _) in zip(sample, oracle):
        got = list(zip(s_b[i, : c_b[i]].tolist(), e_b[i, : c_b[i]].tolist()))
        check(got == ol, "mesh spans", i)
    log(f"  [mesh] per_record_spans ({int(c_b.sum())} spans): equal to one "
        "card and oracle")
    blob = data.reshape(-1)[: n_dev * (mib_per_dev << 20)].tobytes()
    cnt_long = ds.long_stats(blob, mode="count")
    from roaringregex import Pattern

    want_long = Pattern(pat).long.count_ends(blob)
    check(cnt_long == want_long, cnt_long, want_long)
    head = blob[: 1 << 16]
    check(ds.long_stats(head, mode="count") == len(orc.ends(head)))
    log(f"  [mesh] long_stats count={cnt_long} over {len(blob)} B: equal to "
        "one card and oracle (64 KiB prefix)")
    chunks = [(data[k::4], lens[k::4]) for k in range(4)]
    st = ds.stats_stream(iter(chunks))
    check(st.matches == int(r_cnt.sum()) and st.matched_records == int(
        r_any.sum()) and st.bytes == nbytes, st)
    log(f"  [mesh] stats_stream {st}: equal to one card")


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", type=int, default=0,
                    help="run only the DistScanner path on this many GPUs")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes; allows the CPU platform")
    args = ap.parse_args()
    check_checkout()
    smi = nvidia_smi_lines()
    if not smi and not args.rehearse:
        die("no NVIDIA GPU found (nvidia-smi reports none)", 3)
    if not args.rehearse and not args.mesh:
        phase_a_gpu_tests()

    import jax
    import numpy as np

    from roaringregex import platform
    from roaringregex.compiler import native

    dev = jax.devices()
    plat = platform.platform()
    if plat != "gpu" and not args.rehearse:
        die(f"JAX platform is {plat!r}, not gpu", 3)
    for ln in smi or ["(no nvidia-smi: rehearsal)"]:
        log(f"card: {ln}")
    log(f"phase b: jax {jax.__version__}, platform {plat}, "
        f"{len(dev)} x {dev[0].device_kind}; native library "
        f"{native.ensure_built() or 'NOT built'}")
    check(native.ensure_built(), "native host engine is the reference")
    rng = np.random.default_rng(args.seed)
    small = args.rehearse
    import concurrent.futures as cf
    import multiprocessing as mp

    with cf.ProcessPoolExecutor(
        min(16, os.cpu_count() or 1), mp_context=mp.get_context("spawn")
    ) as pool:
        if args.mesh:
            phase_mesh(pool, rng, args.mesh, 1 if small else 64,
                       50 if small else 1000)
            count = args.mesh
        else:
            phase_c(pool, rng, 1 if small else 64, 1 if small else 4,
                    50 if small else 1000)
            phase_d(rng, 1 if small else 128, 1 << 12 if small else 1 << 16)
            phase_e(rng, 4 if small else 1024, 50 if small else 1000)
            phase_f(rng, 1 if small else 64)
            count = len(dev)
    shutil.rmtree(os.path.join(HERE, ".smoke_data"), ignore_errors=True)
    for ln in smi or ["(no nvidia-smi: rehearsal)"]:
        log(f"card: {ln}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev[0].platform,
            "kind": dev[0].device_kind,
            "count": count,
        },
    }), flush=True)


if __name__ == "__main__":
    main()
