"""ctypes binding to the native host runtime (native/rrx_host.cc).

The reference's compiler is C++ (Parser.cpp, NFA.cc); this is the
framework's native equivalent: a shared library implementing the
POSIX-ERE -> Glushkov build and the newline-record corpus packer, bound
via ctypes (no pybind11 in this environment). Falls back to the pure
Python compiler transparently when the library is missing; parity between
the two is enforced by tests/test_native.py.

Build: ``make -C native`` (or it is built on demand by ``ensure_built``).
"""
from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from .nfa import NFA, PatternTooLargeError
from .parser import NSYM, RegexSyntaxError

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SRC_PATH = os.path.join(_NATIVE_DIR, "rrx_host.cc")


def _lib_path() -> str:
    """The library built from the current ``rrx_host.cc``: its file name
    carries a hash of the source, so a library built from another version
    of the source is never loaded."""
    try:
        with open(_SRC_PATH, "rb") as f:
            h = hashlib.sha256(f.read()).hexdigest()[:12]
    except OSError:
        h = "nosrc"
    return os.path.join(_NATIVE_DIR, f"librrx_host-{h}.so")


_LIB_PATH = _lib_path()
_LABEL_BYTES = (NSYM + 7) // 8

_lock = threading.Lock()
_lib: Optional[ct.CDLL] = None
_lib_failed = False


def ensure_built(build: bool = True) -> Optional[str]:
    """Return the shared-library path, building it if needed and possible."""
    if os.path.exists(_LIB_PATH):
        return _LIB_PATH
    if not build:
        return None
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"LIB={os.path.basename(_LIB_PATH)}"],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        return None
    return _LIB_PATH if os.path.exists(_LIB_PATH) else None


def _load() -> Optional[ct.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        from ..utils.config import get_config

        if not get_config().native:
            return None  # disabled by config; not cached as failure
        path = ensure_built(build=True)
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ct.CDLL(path)
            _bind(lib)
        except (OSError, AttributeError):
            # A stale prebuilt .so (e.g. surviving a git pull, missing
            # newly added symbols) must not take down compilation: force
            # one rebuild and load the fresh artifact via a temp copy
            # (dlopen caches by path, and the failed handle above may pin
            # the old mapping).
            lib = _rebuild_and_load()
            if lib is None:
                _lib_failed = True
                return None
        _lib = lib
        return _lib


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _rebuild_and_load() -> Optional[ct.CDLL]:
    import shutil
    import tempfile

    try:
        subprocess.run(
            ["make", "-B", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        tmp = tempfile.NamedTemporaryFile(
            suffix=".so", delete=False, prefix="rrx_host_"
        )
        tmp.close()
        shutil.copy2(_LIB_PATH, tmp.name)
        lib = ct.CDLL(tmp.name)
        # reclaim the per-process copy at exit (dlopen holds it mapped
        # until then; unlinking now would work on Linux but atexit keeps
        # the file visible for debuggers while the process lives)
        import atexit

        atexit.register(lambda p=tmp.name: _unlink_quiet(p))
        _bind(lib)
        return lib
    except Exception:
        return None


def _bind(lib: ct.CDLL) -> None:
    """Declare every symbol's signature; raises AttributeError on a stale
    library missing newer entry points."""
    lib.rrx_compile.restype = ct.c_void_p
    lib.rrx_compile.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int]
    lib.rrx_n_states.restype = ct.c_long
    lib.rrx_n_states.argtypes = [ct.c_void_p]
    lib.rrx_nullable.restype = ct.c_int
    lib.rrx_nullable.argtypes = [ct.c_void_p]
    lib.rrx_n_edges.restype = ct.c_long
    lib.rrx_n_edges.argtypes = [ct.c_void_p]
    lib.rrx_edges.argtypes = [ct.c_void_p, ct.c_void_p]
    lib.rrx_labels.argtypes = [ct.c_void_p, ct.c_void_p]
    lib.rrx_n_accept.restype = ct.c_long
    lib.rrx_n_accept.argtypes = [ct.c_void_p]
    lib.rrx_accept.argtypes = [ct.c_void_p, ct.c_void_p]
    lib.rrx_free.argtypes = [ct.c_void_p]
    lib.rrx_scan_records.restype = ct.c_long
    lib.rrx_scan_records.argtypes = [ct.c_void_p, ct.c_long, ct.c_void_p]
    lib.rrx_pack_lines.restype = ct.c_long
    lib.rrx_pack_lines.argtypes = [
        ct.c_void_p, ct.c_long, ct.c_long, ct.c_long, ct.c_void_p,
        ct.c_void_p,
    ]
    lib.rrx_scanner_new.restype = ct.c_void_p
    lib.rrx_scanner_new.argtypes = [ct.c_void_p]
    lib.rrx_scanner_free.argtypes = [ct.c_void_p]
    lib.rrx_fullmatch.restype = ct.c_int
    lib.rrx_fullmatch.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_long]
    lib.rrx_count_ends.restype = ct.c_long
    lib.rrx_count_ends.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_long, ct.c_void_p,
    ]
    lib.rrx_spans.restype = ct.c_long
    lib.rrx_spans.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_long, ct.c_int,
        ct.c_void_p, ct.c_void_p, ct.c_long,
    ]
    lib.rrx_grep_lines.restype = ct.c_long
    lib.rrx_grep_lines.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_long, ct.c_void_p, ct.c_long,
    ]


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# Compiler fast path
# ---------------------------------------------------------------------------


def build_nfa_native(pattern: str) -> Optional[NFA]:
    """Compile via the native library; None if unavailable. Raises
    RegexSyntaxError / PatternTooLargeError on invalid patterns (same
    exception surface as the Python compiler)."""
    lib = _load()
    if lib is None:
        return None
    err = ct.create_string_buffer(256)
    try:
        pat_b = pattern.encode("ascii")
    except UnicodeEncodeError:
        raise RegexSyntaxError(
            f"non-ASCII pattern (reference is ASCII-only): {pattern!r}"
        )
    handle = lib.rrx_compile(pat_b, err, 256)
    if not handle:
        msg = err.value.decode("utf-8", "replace")
        if "MAX_STATES" in msg:
            raise PatternTooLargeError(msg)
        raise RegexSyntaxError(msg)
    try:
        S = int(lib.rrx_n_states(handle))
        nullable = bool(lib.rrx_nullable(handle))
        ne = int(lib.rrx_n_edges(handle))
        edges = np.empty(ne * 2, dtype=np.int32)
        if ne:
            lib.rrx_edges(handle, edges.ctypes.data_as(ct.c_void_p))
        labels_raw = np.empty((S - 1) * _LABEL_BYTES, dtype=np.uint8)
        if S > 1:
            lib.rrx_labels(handle, labels_raw.ctypes.data_as(ct.c_void_p))
        na = int(lib.rrx_n_accept(handle))
        accept = np.empty(na, dtype=np.int32)
        if na:
            lib.rrx_accept(handle, accept.ctypes.data_as(ct.c_void_p))
    finally:
        lib.rrx_free(handle)

    # vectorized reconstruction: keep the follow relation as a sorted edge
    # array (the list-of-sets view materializes lazily only if needed)
    e = edges.reshape(-1, 2)
    order = np.lexsort((e[:, 1], e[:, 0]))
    e = np.ascontiguousarray(e[order])
    lr = labels_raw.reshape(max(S - 1, 0), _LABEL_BYTES)
    bits = np.unpackbits(lr, axis=-1, bitorder="little")[:, :NSYM]
    labels: List[frozenset] = [
        frozenset(row.tolist()) for row in
        (np.nonzero(bits[p])[0] for p in range(S - 1))
    ]
    nfa = NFA(
        pattern=pattern,
        n_states=S,
        labels=labels,
        accept_set=set(accept.tolist()),
        nullable=nullable,
        edges=e,
    )
    # pre-populate the dense table caches with vectorized scatters so
    # compile_program never loops over Python sets on the hot path
    if S <= 4096:
        F = np.zeros((S, S), dtype=np.uint8)
        if len(e):
            F[e[:, 0], e[:, 1]] = 1
        nfa._follow_mat = F
        symtab = np.zeros((NSYM, S), dtype=np.uint8)
        if S > 1:
            symtab[:, 1:] = bits.T
        nfa._symtab = symtab
        av = np.zeros(S, dtype=np.uint8)
        av[accept] = 1
        nfa._accept_vec = av
    return nfa


# ---------------------------------------------------------------------------
# Corpus packer (data loader)
# ---------------------------------------------------------------------------


def pack_corpus_native(
    buf: bytes, G: int = 1, min_L: int = 16
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Split a newline-delimited byte buffer into the padded [B, L] uint8 +
    lengths layout (B padded to a multiple of G, L a power of two) plus the
    real record count. None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(buf)
    src = np.frombuffer(buf, dtype=np.uint8)
    max_len = ct.c_long(0)
    count = int(
        lib.rrx_scan_records(
            src.ctypes.data_as(ct.c_void_p), n, ct.byref(max_len)
        )
    )
    L = min_L
    while L < max(int(max_len.value), 1):
        L *= 2
    Bp = max(G, ((count + G - 1) // G) * G)
    data = np.zeros((Bp, L), dtype=np.uint8)
    lengths = np.zeros(Bp, dtype=np.int32)
    got = int(
        lib.rrx_pack_lines(
            src.ctypes.data_as(ct.c_void_p),
            n,
            Bp,
            L,
            data.ctypes.data_as(ct.c_void_p),
            lengths.ctypes.data_as(ct.c_void_p),
        )
    )
    assert got == count, (got, count)
    return data, lengths, count


# ---------------------------------------------------------------------------
# Host scan engine (self-contained CPU matching, no device runtime)
# ---------------------------------------------------------------------------


class HostEngine:
    """CPU matcher over the native scan loop (native/rrx_host.cc
    RrxScanner) — the self-contained-library capability the reference
    ships as librregex.a (its Processor::shift row-union loop,
    NFA.cc:72-102), with 32-bit state ids and working anchors. Semantics
    match the oracle (fullmatch / seeded ends); the device engine remains
    the production path."""

    def __init__(self, pattern: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native host library unavailable (RRX_NATIVE=0 or build "
                "failed); use the device engine instead"
            )
        err = ct.create_string_buffer(256)
        try:
            pat_b = pattern.encode("ascii")
        except UnicodeEncodeError:
            raise RegexSyntaxError("pattern must be ASCII")
        ph = lib.rrx_compile(pat_b, err, 256)
        if not ph:
            msg = err.value.decode("ascii", "replace")
            if "MAX_STATES" in msg:
                raise PatternTooLargeError(msg)
            raise RegexSyntaxError(msg)
        self._lib = lib
        self._prog = ph
        self._scan = lib.rrx_scanner_new(ph)

    def __del__(self):  # pragma: no cover - interpreter teardown order
        lib = getattr(self, "_lib", None)
        if lib is None:
            return
        if getattr(self, "_scan", None):
            lib.rrx_scanner_free(self._scan)
            self._scan = None
        if getattr(self, "_prog", None):
            lib.rrx_free(self._prog)
            self._prog = None

    @staticmethod
    def _buf(text) -> bytes:
        return text.encode("ascii") if isinstance(text, str) else bytes(text)

    def fullmatch(self, text) -> bool:
        b = self._buf(text)
        return bool(self._lib.rrx_fullmatch(self._scan, b, len(b)))

    def count_ends(self, text) -> int:
        b = self._buf(text)
        return int(self._lib.rrx_count_ends(self._scan, b, len(b), None))

    def first_end(self, text) -> int:
        """Smallest match-end position, or -1."""
        b = self._buf(text)
        first = ct.c_long(-1)
        self._lib.rrx_count_ends(self._scan, b, len(b), ct.byref(first))
        return int(first.value)

    def search(self, text) -> bool:
        return self.count_ends(text) > 0

    def finditer(self, text, *, longest: bool = False):
        """Non-overlapping spans, oracle finditer policy: leftmost start,
        shortest end (lazy) or ``longest=True`` leftmost-longest (greedy
        POSIX) — all on the host, no device runtime."""
        b = self._buf(text)
        cap = 64
        while True:
            starts = (ct.c_long * cap)()
            ends = (ct.c_long * cap)()
            n = int(
                self._lib.rrx_spans(
                    self._scan, b, len(b), int(longest), starts, ends, cap
                )
            )
            if n <= cap:
                return [(int(starts[i]), int(ends[i])) for i in range(n)]
            cap = n  # exact total: one re-run always suffices

    def findall(self, text, *, longest: bool = False):
        """Matched byte substrings — mirrors ``Pattern.findall`` (which
        returns bytes, not spans); use :meth:`finditer` for (start, end)."""
        b = self._buf(text)
        return [b[s:e] for s, e in self.finditer(text, longest=longest)]

    def grep_lines(self, buf) -> "np.ndarray":
        """[n_records] bool hit flags over a newline-delimited buffer in
        ONE native call (seeded scan, early exit per record) — the CLI
        grep fast path."""
        import numpy as np

        b = self._buf(buf)
        # record count bound: newlines + a possible trailing record
        cap = b.count(b"\n") + 1
        hits = np.zeros((cap + 7) // 8, np.uint8)
        n = int(
            self._lib.rrx_grep_lines(
                self._scan, b, len(b),
                hits.ctypes.data_as(ct.c_void_p), cap,
            )
        )
        assert n >= 0, "record cap underestimated"
        return np.unpackbits(hits, bitorder="little")[:n].astype(bool)
