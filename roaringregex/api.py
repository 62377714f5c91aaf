"""High-level matching API: the ``RRegex`` / ``get_acceptance_iter`` analog.

The reference exposes compile-once / match-many via ``RRegex`` +
type-erased acceptance iterators (regex.h:212-228, 150-165). Here the same
shape is ``compile()`` -> :class:`Pattern` with:

* single-string convenience (``fullmatch``, ``search``, ``match``,
  ``finditer``, ``findall``) -- correct for any input, routed through the
  batched device engine;
* batched production entry points (``fullmatch_batch``, ``search_batch``,
  ``count_batch``, ``finditer_batch``, ``grep``) -- the device-native
  shape: many records scanned in parallel lanes.

Span semantics are the normative lazy policy defined by the oracle
(leftmost start, shortest end, non-overlapping, empty matches advance by
one). Span extraction = one seeded forward scan (ends), one reverse scan
(starts), then per-match anchored scans batched across records in rounds.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .compiler.nfa import build_nfa
from .compiler.program import DeviceProgram, compile_program
from .engine import ScanEngine
from .oracle.engine import OracleEngine

TextLike = Union[str, bytes]


@dataclass(frozen=True)
class Match:
    """A match span [start, end) -- the reference's ``Match`` (regex.h:100)."""

    start: int
    end: int
    text: bytes

    def group(self) -> bytes:
        return self.text[self.start : self.end]

    def span(self) -> Tuple[int, int]:
        return (self.start, self.end)

    def __repr__(self):  # pragma: no cover
        return f"<Match span=({self.start},{self.end}) group={self.group()!r}>"


def _as_bytes(t: TextLike) -> bytes:
    return t.encode("ascii") if isinstance(t, str) else bytes(t)


def _pow2(n: int, lo: int = 8) -> int:
    x = lo
    while x < n:
        x *= 2
    return x


class Pattern:
    """A compiled pattern bound to a scan engine."""

    def __init__(self, pattern: str, backend: Optional[str] = None):
        from .compiler.serialize import cached_compile

        # honors RRX_CACHE_DIR (content-addressed compiled-program cache)
        self.program: DeviceProgram = cached_compile(pattern)
        self.engine = ScanEngine(self.program, backend=backend)
        self._oracle: Optional[OracleEngine] = None

    @property
    def oracle(self) -> OracleEngine:
        """Lazily-built executable-spec engine (it walks Python sets, which
        is off the hot compile path for repetition-heavy patterns)."""
        if self._oracle is None:
            self._oracle = OracleEngine(self.program.nfa)
        return self._oracle

    # -- introspection ----------------------------------------------------
    @property
    def pattern(self) -> str:
        return self.program.pattern

    @property
    def n_states(self) -> int:
        return self.program.n_states

    @property
    def tier(self) -> str:
        return self.program.tier

    def dump(self, full: bool = False) -> str:
        """NFA dump (the reference's NFA::print analog, NFA.cc:14-41);
        ``full=True`` adds per-state per-symbol fwd+bwd transition rows."""
        return self.program.nfa.dump(full=full)

    # -- batching helpers --------------------------------------------------
    def _pack(self, texts: Sequence[TextLike]):
        bs = [_as_bytes(t) for t in texts]
        B = len(bs)
        maxlen = max((len(b) for b in bs), default=0)
        # pad B so packed engines can group G records per row
        Bp = _pow2(B, lo=max(8, self.program.G))
        Lp = _pow2(max(maxlen, 1), lo=16)
        data = np.zeros((Bp, Lp), dtype=np.uint8)
        lengths = np.zeros(Bp, dtype=np.int32)
        for i, b in enumerate(bs):
            data[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lengths[i] = len(b)
        return data, lengths, B, maxlen

    # -- batched entry points ----------------------------------------------
    def fullmatch_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        data, lengths, B, _ = self._pack(texts)
        return self.engine.fullmatch_flags(data, lengths)[:B]

    def search_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        data, lengths, B, _ = self._pack(texts)
        _, _, anym = self.engine.match_stats(data, lengths, seeded=True)
        return np.asarray(anym)[:B]

    def count_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        """Number of distinct match-end positions per record."""
        data, lengths, B, _ = self._pack(texts)
        cnt, _, _ = self.engine.match_stats(data, lengths, seeded=True)
        return np.asarray(cnt)[:B]

    def ends_batch(self, texts: Sequence[TextLike]) -> List[List[int]]:
        data, lengths, B, maxlen = self._pack(texts)
        bm = self.engine.ends_bitmap(data, lengths, maxlen)
        return [
            [int(p) for p in np.nonzero(bm[i])[0] if p <= lengths[i]]
            for i in range(B)
        ]

    def starts_batch(self, texts: Sequence[TextLike]) -> List[List[int]]:
        data, lengths, B, maxlen = self._pack(texts)
        bm = self.engine.starts_bitmap(data, lengths, maxlen)
        return [
            [int(p) for p in np.nonzero(bm[i])[0] if p <= lengths[i]]
            for i in range(B)
        ]

    def finditer_batch(
        self, texts: Sequence[TextLike], *, longest: bool = False
    ) -> List[List[Tuple[int, int]]]:
        """Non-overlapping spans for every record: lazy (leftmost-shortest,
        default) or greedy (``longest=True``, leftmost-longest — POSIX).

        On the ``pallas`` route the whole enumeration runs on device as
        one program (engine.spans: one reverse pass, then a while_loop of
        anchored rescans). Other routes use host-driven rounds of batched
        anchored scans.
        """
        data, lengths, B, maxlen = self._pack(texts)
        if self.engine.device_spans:
            return self._finditer_device(data, lengths, B, maxlen, longest)
        bm = self.engine.starts_bitmap(data, lengths, maxlen)  # [Bp, maxlen+1]
        nullable = self.program.nullable
        Bp = bm.shape[0]
        spans: List[List[Tuple[int, int]]] = [[] for _ in range(Bp)]
        pos = np.zeros(Bp, dtype=np.int64)
        active = np.array(
            [i < B for i in range(Bp)]
        )  # padding records inactive
        cols = np.arange(bm.shape[1])[None, :]
        while True:
            # vectorized next-start: first candidate bit at/after pos
            mask = bm & (cols >= pos[:, None]) & (cols <= lengths[:, None])
            mask &= active[:, None]
            has = mask.any(axis=1)
            starts = np.where(has, mask.argmax(axis=1), -1).astype(np.int32)
            active &= has
            if not active.any():
                break
            if nullable and not longest:
                ends = starts  # lazy end of a nullable pattern is the start
            else:
                ends = np.asarray(
                    self.engine.first_end_from(
                        data, lengths, starts, longest=longest
                    )
                )
                if nullable:
                    # greedy nullable: empty match at s is the fallback when
                    # no longer match starts there
                    ends = np.where(ends >= starts, ends, starts)
            for i in np.nonzero(active)[0]:
                s, e = int(starts[i]), int(ends[i])
                assert e >= s, (self.pattern, i, s, e)
                spans[i].append((s, e))
                pos[i] = e if e > s else s + 1
                if pos[i] > lengths[i]:
                    active[i] = False
        return spans[:B]

    def _finditer_device(self, data, lengths, B, maxlen, longest):
        """Device-side span enumeration (see finditer_batch)."""
        eng = self.engine
        len_g = np.asarray(lengths).reshape(-1, self.program.G)
        nullable = self.program.nullable
        if nullable and not longest:
            # lazy spans of a nullable pattern: the empty match at every
            # position (shortest end == start, advance by one)
            return [
                [(p, p) for p in range(int(lengths[i]) + 1)] for i in range(B)
            ]
        # Pre-size the span buffers from one counts pass: every emitted
        # span (lazy or greedy) ends at a distinct match-end position, so
        # n_spans <= match_stats count per record. Bucketing to a power of
        # two bounds the jit cache to log(maxlen) program variants.
        if nullable:
            # nullable greedy: the empty-match fallback makes every
            # position a potential span start
            mx = int(np.asarray(lengths)[:B].max()) + 1 if B else 1
        else:
            cnt0, _, _ = eng.match_stats(data, lengths, seeded=True)
            mx = int(np.asarray(cnt0)[:B].max()) if B else 0
        cap = _pow2(min(max(mx, 1), maxlen + 1 if maxlen else 1), lo=1)
        while True:
            s_buf, e_buf, cnt, over = eng.spans(
                data, lengths, cap=cap, longest=longest
            )
            if not bool(np.asarray(over)[:B].any()) or cap > maxlen:
                break
            cap = _pow2(cap * 4)  # unreachable safety net
        s_np, e_np, c_np = np.asarray(s_buf), np.asarray(e_buf), np.asarray(cnt)
        return [
            list(zip(s_np[i, : c_np[i]].tolist(), e_np[i, : c_np[i]].tolist()))
            for i in range(B)
        ]

    def grep(self, lines: Sequence[TextLike]) -> List[int]:
        """Indices of records containing a match (the grep-style entry)."""
        hits = self.search_batch(lines)
        return [i for i, h in enumerate(hits) if h]

    # -- single-string convenience ------------------------------------------
    def fullmatch(self, text: TextLike) -> Optional[Match]:
        b = _as_bytes(text)
        if bool(self.fullmatch_batch([b])[0]):
            return Match(0, len(b), b)
        return None

    def search(self, text: TextLike) -> Optional[Match]:
        b = _as_bytes(text)
        spans = self.finditer_batch([b])[0]
        return Match(*spans[0], b) if spans else None

    def match(self, text: TextLike) -> Optional[Match]:
        """Anchored-at-0 lazy prefix match."""
        b = _as_bytes(text)
        if self.program.nullable:
            return Match(0, 0, b)
        data, lengths, _, _ = self._pack([b])
        starts = np.full(data.shape[0], -1, np.int32)
        starts[0] = 0
        e = int(np.asarray(self.engine.first_end_from(data, lengths, starts))[0])
        return Match(0, e, b) if e >= 0 else None

    # -- host-only matching (no device runtime) -----------------------------
    @property
    def host(self):
        """Self-contained CPU matcher (compiler/native.py HostEngine over
        native/rrx_host.cc): ``pat.host.fullmatch/search/count_ends/
        finditer/grep_lines``. The librregex.a capability of the
        reference, with lazy-DFA subset caching on the <=64 and <=128
        state tiers (~150-220 MB/s/core) — matching with no JAX/device
        runtime. Raises RuntimeError if the native library is
        unavailable."""
        if getattr(self, "_host", None) is None:
            from .compiler.native import HostEngine

            self._host = HostEngine(self.pattern)
        return self._host

    # -- one-long-string mode (sequence parallelism) -----------------------
    @property
    def long(self):
        """Block-parallel scanner for ONE huge string (ops/longstring.py):
        ``pat.long.search(blob)``, ``count_ends``, ``fullmatch``,
        ``ends_bitmap``. Accepts bytes or a device-resident uint8 array."""
        if getattr(self, "_long", None) is None:
            from .ops.longstring import make_long_scanner
            from .utils.config import get_config

            self._long = make_long_scanner(
                self.program, block=get_config().long_block
            )
        return self._long

    def finditer_long(
        self, text: TextLike, *, longest: bool = False, chunk: int = 4096
    ) -> List[Tuple[int, int]]:
        """Non-overlapping spans over ONE long string, same policies as
        finditer_batch (lazy leftmost-shortest / greedy leftmost-longest).

        Bounded-horizon (acyclic) patterns: candidate starts come from
        one overlapped reverse pass (FastLongScanner.starts_bitmap) and
        match ends from batched anchored rescans over tiny per-candidate
        slices — the sequential non-overlap sweep runs host-side over
        candidates, not bytes. Cyclic (unbounded-match-length) patterns
        take `_finditer_long_cyclic`: starts via the REVERSED program's
        long ends scan, ends via doubling-window rescans.
        """
        data = _as_bytes(text)
        n = len(data)
        if n == 0:
            # trivial input; the candidate-slice path below assumes n >= 1
            from .oracle.engine import OracleEngine

            return list(
                OracleEngine(self.program.nfa).finditer(b"", longest=longest)
            )
        lam = self.program.horizon
        sc = self.long
        if not self.program.nullable and hasattr(sc, "spans"):
            # counting-plan patterns: closed-form non-overlap enumeration
            # (a lazy match is exactly m body copies, a greedy one
            # min(copies, n)) — works for unbounded X{m,} too, where no
            # finite horizon exists for the generic candidate path
            return sc.spans(data, longest=longest)
        if lam is None or getattr(sc, "overlap", None) is None:
            # cyclic (unbounded-match-length) patterns: candidate starts
            # come from the REVERSED program's long ends scan, ends from
            # doubling-window anchored rescans
            return self._finditer_long_cyclic(
                data, n, longest=longest, chunk=chunk
            )
        nullable = self.program.nullable
        if nullable and not longest:
            # lazy spans of a nullable pattern: the empty match everywhere
            return [(p, p) for p in range(n + 1)]
        cand = np.nonzero(sc.starts_bitmap(data))[0]
        if cand.size == 0:
            return []
        arr = np.frombuffer(data, np.uint8)
        G = self.program.G
        L_rec = lam + 2  # 1 byte of left context + a <= lam-byte match
        spans: List[Tuple[int, int]] = []
        cursor = 0
        for c0 in range(0, cand.size, chunk):
            cc = cand[c0 : c0 + chunk]
            if cc[-1] < cursor:
                continue  # whole chunk already claimed by a prior match
            # slices with one byte of left context so interior windows
            # never expose a fake BOS (^ must not fire mid-string)
            g0 = np.maximum(cc.astype(np.int64) - 1, 0)
            idx = g0[:, None] + np.arange(L_rec)[None, :]
            sl = np.where(idx < n, arr[np.minimum(idx, n - 1)], 0).astype(
                np.uint8
            )
            lens = np.minimum(L_rec, n - g0).astype(np.int32)
            starts_loc = (cc - g0).astype(np.int32)
            K = len(cc)
            Kp = -(-K // G) * G
            if Kp != K:
                sl = np.pad(sl, ((0, Kp - K), (0, 0)))
                lens = np.pad(lens, (0, Kp - K))
                starts_loc = np.pad(
                    starts_loc, (0, Kp - K), constant_values=-1
                )
            e_loc = np.asarray(
                self.engine.first_end_from(
                    sl, lens, starts_loc, longest=longest
                )
            )[:K]
            ends = np.where(e_loc >= 0, g0 + e_loc, -1)
            if nullable:  # greedy nullable: empty match is the fallback
                ends = np.maximum(ends, cc)
            for s, e in zip(cc.tolist(), ends.tolist()):
                if s < cursor or e < 0:
                    continue
                spans.append((s, e))
                cursor = e if e > s else s + 1
                if cursor > n:
                    break
            if cursor > n:
                break
        return spans

    @property
    def rev_long(self):
        """Long scanner over the REVERSED program (compiler.parser.
        reverse_node): its seeded end positions in reversed text are this
        pattern's start positions — the two-pass forward/backward span
        scheme the reference scaffolded but never wired (regex.h:144-146,
        NFA.cc:52-53), working for ANY pattern including cyclic ones."""
        if getattr(self, "_rev_long", None) is None:
            from .compiler.nfa import build_nfa_ast
            from .compiler.parser import parse, reverse_node
            from .compiler.program import compile_program
            from .ops.longstring import make_long_scanner
            from .utils.config import get_config

            ast = reverse_node(parse(self.pattern))
            nfa = build_nfa_ast(ast, f"<rev:{self.pattern}>")
            self._rev_long = make_long_scanner(
                compile_program(nfa), block=get_config().long_block
            )
        return self._rev_long

    def _finditer_long_cyclic(
        self, data: bytes, n: int, *, longest: bool, chunk: int
    ) -> List[Tuple[int, int]]:
        """finditer_long past the bounded-horizon wall (round-5 task):

        1. candidate starts = the reversed program's ends over the
           reversed text (exact for any pattern; a match of P starts at
           s iff a match of rev(P) ends at n - s in rev(text));
        2. lazy ends: batched anchored rescans over per-candidate slices
           whose window doubles until the (guaranteed) first end lands
           inside — total work ~ sum of match lengths;
        3. greedy ends: per-claim full-tail rescans (the last accepting
           end can sit anywhere up to EOS, and claims are sequential by
           the non-overlap policy) — work ~ sum of claimed match lengths.
        """
        nullable = self.program.nullable
        if nullable and not longest:
            return [(p, p) for p in range(n + 1)]
        rends = np.asarray(self.rev_long.ends_bitmap(data[::-1]))
        starts_bm = rends[::-1]  # rev end at n - s <-> start at s
        cand = np.nonzero(starts_bm)[0]
        if cand.size == 0:
            return []
        arr = np.frombuffer(data, np.uint8)
        G = self.program.G
        spans: List[Tuple[int, int]] = []
        cursor = 0

        def anchored_ends(cc: np.ndarray, w: int) -> np.ndarray:
            """Anchored ends for starts ``cc`` over [start-1, start+w)
            slices (one byte of left context; window clipped at EOS).
            The slice width buckets to a power of two so the jit cache
            sees O(log n) shapes, not one per claim."""
            g0 = np.maximum(cc.astype(np.int64) - 1, 0)
            L_rec = _pow2(min(w + 1, n + 2), lo=16)
            idx = g0[:, None] + np.arange(L_rec)[None, :]
            sl = np.where(idx < n, arr[np.minimum(idx, n - 1)], 0).astype(
                np.uint8
            )
            lens = np.minimum(L_rec, n - g0).astype(np.int32)
            starts_loc = (cc - g0).astype(np.int32)
            K = len(cc)
            Kp = -(-K // G) * G
            if Kp != K:
                sl = np.pad(sl, ((0, Kp - K), (0, 0)))
                lens = np.pad(lens, (0, Kp - K))
                starts_loc = np.pad(
                    starts_loc, (0, Kp - K), constant_values=-1
                )
            e_loc = np.asarray(
                self.engine.first_end_from(
                    sl, lens, starts_loc, longest=longest
                )
            )[:K]
            return np.where(e_loc >= 0, g0 + e_loc, -1)

        if longest:
            # sequential claims; each claim scans its full tail once
            ci = 0
            while ci < cand.size and cursor <= n:
                while ci < cand.size and cand[ci] < cursor:
                    ci += 1
                if ci >= cand.size:
                    break
                s = int(cand[ci])
                e = int(anchored_ends(np.asarray([s]), n - s + 1)[0])
                if nullable:
                    e = max(e, s)
                assert e >= s, (self.pattern, s, e)
                spans.append((s, e))
                cursor = e if e > s else s + 1
                ci += 1
            return spans

        # lazy: batched per-candidate ends with doubling windows,
        # processed in ``chunk``-sized candidate blocks (bounds the
        # [K, w] slice memory)
        for c0 in range(0, cand.size, chunk):
            cc = cand[c0 : c0 + chunk]
            if cc[-1] < cursor:
                continue
            ends = np.full(cc.size, -1, np.int64)
            unresolved = np.arange(cc.size)
            w = 256
            while unresolved.size:
                got = anchored_ends(cc[unresolved], min(w, n + 1))
                ends[unresolved] = got
                if w > n:
                    # candidates are exact match starts; a miss at full
                    # length would mean the reverse scan lied
                    assert (got >= 0).all(), self.pattern
                    break
                unresolved = unresolved[got < 0]
                w *= 2
            for s, e in zip(cc.tolist(), ends.tolist()):
                if s < cursor or e < 0:
                    continue
                spans.append((int(s), int(e)))
                cursor = e if e > s else s + 1
                if cursor > n:
                    break
            if cursor > n:
                break
        return spans

    def finditer(
        self, text: TextLike, *, longest: bool = False
    ) -> Iterator[Match]:
        b = _as_bytes(text)
        for s, e in self.finditer_batch([b], longest=longest)[0]:
            yield Match(s, e, b)

    def findall(self, text: TextLike, *, longest: bool = False) -> List[bytes]:
        return [m.group() for m in self.finditer(text, longest=longest)]


@functools.lru_cache(maxsize=256)
def compile(pattern: str, backend: Optional[str] = None) -> Pattern:  # noqa: A001
    """Compile (with caching) a POSIX-ERE pattern."""
    return Pattern(pattern, backend=backend)


class MultiPattern:
    """Several patterns compiled into ONE automaton, scanned in one pass.

    The Glushkov union shares the start state but keeps each pattern's
    positions disjoint, so a single device scan tracks per-pattern accept
    channels — the multi-pattern grep of BASELINE config 5 without P
    separate passes. Per-record-per-pattern stats come out of the same
    kernels by widening the accept map from [lanes, G] to [lanes, G*P],
    passed first-class to ScanEngine (accept_map / channels_per_record).

    Falls back to per-pattern scans only on the unpacked XLA engine
    (single accept channel); the packed and word-kernel routes scan once.
    """

    def __init__(self, patterns: Sequence[str], backend: Optional[str] = None):
        from .compiler.nfa import build_nfa, combine_nfas

        self.patterns = [str(p) for p in patterns]
        if not self.patterns:
            raise ValueError("no patterns")
        self.P = len(self.patterns)
        self.backend = backend
        nfas = [build_nfa(p) for p in self.patterns]
        self.nullables = np.array([n.nullable for n in nfas])
        combined, accepts = combine_nfas(nfas)
        self.program = compile_program(combined)
        self._singles: Optional[List[Pattern]] = None
        self._spanners: Optional[List[Pattern]] = None
        prog = self.program
        P = self.P
        if prog.tier == "sparse":
            # accept channels over the padded state lanes (G = 1)
            A = np.zeros((prog.s_pad, P), np.uint8)
            for p, aset in enumerate(accepts):
                for st in aset:
                    if st > 0:  # state 0 handled via nullable correction
                        A[st, p] = 1
        else:
            # channel = g*P + p over the lane-packed layout
            s_tile, G, lanes = prog.s_tile, prog.G, prog.lanes
            acc_tile = np.zeros((P, s_tile), np.uint8)
            for p, aset in enumerate(accepts):
                for st in aset:
                    if st > 0:
                        acc_tile[p, st] = 1
            A = np.zeros((lanes, G * P), np.uint8)
            for g in range(G):
                for p in range(P):
                    A[g * s_tile : (g + 1) * s_tile, g * P + p] = acc_tile[p]
        # public accept-channel map ([lanes, G*P] dense / [s_pad, P]
        # sparse): the first-class way to build a DistScanner or custom
        # engine over this combined automaton (no private-attr reads)
        self.accept_map = A
        self.engine = ScanEngine(
            prog,
            backend=backend,
            accept_map=A,
            channels_per_record=P,
            nullable=False,  # nullable channels corrected host-side
        )
        if self.engine.device_scanner is None and not self.engine.packed:
            # the unpacked XLA engine has a single accept channel
            self._singles = [
                Pattern(p, backend=backend) for p in self.patterns
            ]

    # ------------------------------------------------------------------
    def _pack(self, texts: Sequence[TextLike]):
        bs = [_as_bytes(t) for t in texts]
        B = len(bs)
        maxlen = max((len(b) for b in bs), default=0)
        Bp = _pow2(B, lo=max(8, self.program.G))
        Lp = _pow2(max(maxlen, 1), lo=16)
        data = np.zeros((Bp, Lp), dtype=np.uint8)
        lengths = np.zeros(Bp, dtype=np.int32)
        for i, b in enumerate(bs):
            data[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lengths[i] = len(b)
        return data, lengths, B

    def count_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        """[B, P] distinct match-end counts per record per pattern."""
        if self._singles is not None:
            return np.stack(
                [p.count_batch(texts) for p in self._singles], axis=1
            )
        data, lengths, B = self._pack(texts)
        cnt, first, anym = self.engine.match_stats(data, lengths, seeded=True)
        cnt = np.asarray(cnt).reshape(-1, self.P)[:B]
        # nullable channels: empty match ends at every position
        if self.nullables.any():
            ln = lengths[:B, None]
            cnt = np.where(self.nullables[None, :], ln + 1, cnt)
        return cnt

    def search_batch(self, texts: Sequence[TextLike]) -> np.ndarray:
        """[B, P] bool: record contains a match of pattern p."""
        if self._singles is not None:
            return np.stack(
                [p.search_batch(texts) for p in self._singles], axis=1
            )
        return self.count_batch(texts) > 0

    def grep(self, texts: Sequence[TextLike]) -> np.ndarray:
        return self.search_batch(texts)

    def finditer_batch(
        self, texts: Sequence[TextLike], *, longest: bool = False
    ) -> List[List[List[Tuple[int, int]]]]:
        """[P][B] non-overlapping span lists, one per pattern. The
        non-overlap policy (lazy leftmost-shortest / greedy POSIX) is
        defined *within* one pattern, so each pattern enumerates its own
        spans (Pattern.finditer_batch)."""
        return self._finditer_per_pattern(texts, longest=longest)

    def _finditer_per_pattern(
        self, texts: Sequence[TextLike], *, longest: bool
    ) -> List[List[List[Tuple[int, int]]]]:
        if self._spanners is None:
            self._spanners = self._singles or [
                Pattern(p, backend=self.backend) for p in self.patterns
            ]
        return [
            p.finditer_batch(texts, longest=longest) for p in self._spanners
        ]
