"""CLI + compiled-program serialization tests."""
import io
import subprocess
import sys

import numpy as np
import pytest

from roaringregex.compiler.program import compile_program
from roaringregex.compiler.serialize import (
    cached_compile,
    load_program,
    save_program,
)
from roaringregex.oracle.engine import OracleEngine


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "pattern", ["cat|dog", "(ab)*c+d?", "^[a-z]+\\.log$", "a{1,300}", "a*"]
)
def test_program_roundtrip(tmp_path, pattern):
    prog = compile_program(pattern)
    path = str(tmp_path / "prog.npz")
    save_program(prog, path)
    prog2 = load_program(path)
    assert prog2.pattern == prog.pattern
    assert prog2.tier == prog.tier
    assert prog2.n_states == prog.n_states
    assert prog2.nullable == prog.nullable
    if prog.F is not None:
        np.testing.assert_array_equal(prog2.F, prog.F)
    np.testing.assert_array_equal(prog2.Bc, prog.Bc)
    np.testing.assert_array_equal(prog2.accept, prog.accept)
    np.testing.assert_array_equal(prog2.byte_class, prog.byte_class)
    # behavioral identity through the oracle
    o1, o2 = OracleEngine(prog.nfa), OracleEngine(prog2.nfa)
    for t in [b"", b"cat", b"catdog", b"ababccd", b"error.log", b"a" * 299]:
        assert o1.fullmatch(t) == o2.fullmatch(t)
        assert o1.findall(t) == o2.findall(t)


def test_cached_compile(tmp_path):
    d = str(tmp_path / "cache")
    p1 = cached_compile("cat|dog", cache_dir=d)
    import os

    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".npz")
    p2 = cached_compile("cat|dog", cache_dir=d)  # hits the cache
    assert p2.n_states == p1.n_states
    assert OracleEngine(p2.nfa).fullmatch(b"dog")


def test_cached_compile_corrupt_file_recompiles(tmp_path):
    import os

    d = str(tmp_path / "cache")
    os.makedirs(d)
    p1 = cached_compile("abc", cache_dir=d)
    path = os.path.join(d, os.listdir(d)[0])
    with open(path, "wb") as f:
        f.write(b"garbage")
    p2 = cached_compile("abc", cache_dir=d)
    assert p2.n_states == p1.n_states


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _run_cli(args, stdin: bytes):
    from roaringregex import cli

    class _FakeStdin:
        def __init__(self, data: bytes):
            self.buffer = io.BytesIO(data)

        def isatty(self):
            return False

    old_in, old_out, old_err = sys.stdin, sys.stdout, sys.stderr
    sys.stdin = _FakeStdin(stdin)  # type: ignore[assignment]
    out, err = io.StringIO(), io.StringIO()
    sys.stdout, sys.stderr = out, err
    try:
        code = cli.main(args)
    finally:
        sys.stdin, sys.stdout, sys.stderr = old_in, old_out, old_err
    return code, out.getvalue(), err.getvalue()


LINES = b"error: disk full\nall good\nanother error here\nERROR caps\n"


def test_cli_basic_grep():
    code, out, err = _run_cli(["error"], LINES)
    assert code == 0
    assert out.splitlines() == ["error: disk full", "another error here"]


def test_cli_count_and_invert():
    code, out, _ = _run_cli(["-c", "error"], LINES)
    assert out.strip() == "2"
    code, out, _ = _run_cli(["-v", "error"], LINES)
    assert out.splitlines() == ["all good", "ERROR caps"]


def test_cli_line_numbers_and_spans():
    code, out, _ = _run_cli(["-n", "error"], LINES)
    assert out.splitlines() == ["1:error: disk full", "3:another error here"]
    # lazy policy: shortest end, so err(or)? yields "err" spans
    code, out, _ = _run_cli(["-o", "err(or)?"], LINES)
    assert out.splitlines() == ["0-3", "8-11"]


def test_cli_fullmatch_and_exit_codes():
    code, out, _ = _run_cli(["--fullmatch", "all good"], LINES)
    assert code == 0 and out.splitlines() == ["all good"]
    code, out, _ = _run_cli(["zzz999"], LINES)
    assert code == 1 and out == ""
    code, _, err = _run_cli(["a{3,1}"], LINES)
    assert code == 2 and "invalid pattern" in err


def test_cli_files_and_stats(tmp_path):
    f1 = tmp_path / "a.log"
    f1.write_bytes(b"cat here\nnothing\n")
    f2 = tmp_path / "b.log"
    f2.write_bytes(b"dog there\n")
    code, out, err = _run_cli(
        ["--stats", "cat|dog", str(f1), str(f2)], b""
    )
    assert code == 0
    assert out.splitlines() == [f"{f1}:cat here", f"{f2}:dog there"]
    assert "2/3 lines matched" in err


def test_cli_subprocess_smoke():
    r = subprocess.run(
        [sys.executable, "-m", "roaringregex.cli", "-c", "b+"],
        input=b"abc\nbbb\nxyz\n",
        capture_output=True,
        timeout=300,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.strip() == b"2"


def test_cli_multi_pattern():
    code, out, _ = _run_cli(["-e", "error", "-e", "good"], LINES)
    assert out.splitlines() == [
        "error: disk full", "all good", "another error here"
    ]
    code, out, _ = _run_cli(["-c", "-e", "caps", "-e", "zzz"], LINES)
    assert out.strip() == "1"
    # -o with multiple patterns is rejected cleanly
    code, _, err = _run_cli(["-o", "-e", "a", "-e", "b"], LINES)
    assert code == 2 and "single pattern" in err
    # no pattern at all
    code, _, err = _run_cli([], LINES)
    assert code == 2 and "no pattern" in err


def test_cli_host_backend():
    """--backend host: self-contained native CPU scan, no device engine."""
    from roaringregex.compiler import native

    if not native.available():
        pytest.skip("native library unavailable")
    code, out, _ = _run_cli(["--backend", "host", "-n", "error"], LINES)
    assert code == 0
    assert out.splitlines() == ["1:error: disk full", "3:another error here"]
    code, out, _ = _run_cli(["--backend", "host", "-c", "error"], LINES)
    assert code == 0 and out.strip() == "2"
    code, out, _ = _run_cli(
        ["--backend", "host", "--fullmatch", "all good"], LINES
    )
    assert code == 0 and out.splitlines() == ["all good"]
    code, out, _ = _run_cli(["--backend", "host", "-v", "error"], LINES)
    assert out.splitlines() == ["all good", "ERROR caps"]
    code, _, err = _run_cli(["--backend", "host", "a{3,1}"], LINES)
    assert code == 2 and "invalid pattern" in err
    # -o spans on the host engine (lazy policy, device-path format)
    code, out, _ = _run_cli(["--backend", "host", "-n", "-o", "err"], LINES)
    assert code == 0
    assert out.splitlines() == ["1:0-3", "3:8-11"]
    code, out, _ = _run_cli(
        ["--backend", "host", "-o", "--greedy", "er+"], LINES
    )
    assert code == 0 and out.splitlines() == ["0-3", "5-7 8-11 15-17"]
    code, _, err = _run_cli(["--backend", "host", "--long", "err"], LINES)
    assert code == 2


def test_cli_long_mode(tmp_path):
    """--long scans each file as ONE string through both long-scanner
    modes (overlapped windows / summary+replay)."""
    f = tmp_path / "blob.txt"
    f.write_bytes(b"x" * 500 + b"cat" + b"y" * 500 + b"dog" + b"z" * 100)
    code, out, _ = _run_cli(["--long", "-c", "cat|dog", str(f)], b"")
    assert code == 0 and out.strip() == "2"
    code, out, _ = _run_cli(["--long", "-c", "(ab)*c+d", str(f)], b"")
    assert code == 1 and out.strip() == "0"


def test_cli_host_multi_pattern():
    """--backend host -e P1 -e P2: grep-style union via per-pattern
    native grep_lines."""
    from roaringregex.compiler import native

    if not native.available():
        pytest.skip("native library unavailable")
    code, out, _ = _run_cli(
        ["--backend", "host", "-n", "-e", "error", "-e", "good"], LINES
    )
    assert code == 0
    assert out.splitlines() == [
        "1:error: disk full", "2:all good", "3:another error here",
    ]
    code, out, _ = _run_cli(
        ["--backend", "host", "-c", "-e", "error", "-e", "caps"], LINES
    )
    assert code == 0 and out.strip() == "3"


def test_cli_long_spans_cyclic(tmp_path, capsys):
    """--long -o over a cyclic pattern: the reversed-program span path
    through the CLI."""
    from roaringregex.cli import main

    f = tmp_path / "blob.bin"
    f.write_bytes(b"zz" + b"ab" * 6 + b"c" + b"qqq" + b"abc" + b"x" * 40)
    rc = main(["(ab)*c", str(f), "--long", "-o"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    from roaringregex.oracle.engine import OracleEngine

    want = OracleEngine.compile("(ab)*c").findall(f.read_bytes())
    spans_txt = out[0].rsplit(":", 1)[-1]
    got = [tuple(map(int, p.split("-"))) for p in spans_txt.split()]
    assert got == want
