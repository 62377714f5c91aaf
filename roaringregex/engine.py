"""Scan-engine dispatcher: routes batched scans to the chosen path.

``platform.route`` picks the path once per program:

* ``xla``    -- unpacked fused-matmul lax.scan engine (ops/scan_xla.py):
  any tier; the portable reference implementation.
* ``packed`` -- lane-packed lax.scan engine (ops/scan_packed.py): G records
  per row + bit-packed mask streams; dense tiers.
* ``pallas`` -- the Pallas-Triton word kernel (ops/scan_word.py) serves the
  match statistics of programs of at most 32 states; every other primitive
  runs on the packed engine.

Counting-plan programs (fixed-length-body ``X{m,n}``) on the ``pallas``
route take the run-length scanner (ops/scan_count.py) for match
statistics, flags and start hits.

Engine primitives take **raw byte batches** (data [B, L] uint8 + lengths):
the byte->mask translation runs fused and gather-free on device as range
compares against the program's byte runs
(scan_packed.mask_stream_from_bytes); class-id streams are only
materialized for the unpacked paths.

The engine owns device table placement and the jit caches; the API layer
(api.py) owns string packing and span-pairing logic.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import platform
from .compiler.program import DeviceProgram
from .ops import scan_xla as sx


def seeded_alias_program(prog: DeviceProgram):
    """DeviceProgram for the X{m,} alias of a whole-pattern X{m,n} on a
    big-automaton tier, or None.

    Under SEEDED semantics (match may start anywhere) the upper
    repetition bound is unobservable: any chain of L >= m consecutive
    X-matches ending (or starting) at a position contains a min(L, n)-copy
    sub-chain ending (starting) there, so the ends, starts, count,
    first-end and lazy-span sets of ``X{m,n}`` equal those of ``X{m,}`` —
    and the n-fold Glushkov position blowup that forces the >1024-state
    block-sparse tier (the family the reference's Roaring tier exists for,
    Parser.cpp:165-168) collapses to the m-copy automaton. Unseeded
    scans (fullmatch, anchored greedy rescans) must keep the original
    program — the bound is observable there. Shared by ScanEngine
    (batched records) and make_long_scanner (one long string)."""
    if prog.tier not in ("multiblock", "sparse"):
        return None
    from .utils.config import get_config

    if not get_config().seeded_alias:
        return None
    from .ops.scan_count import counting_plan

    if counting_plan(prog) is not None:
        return None  # run-length tier already collapses it
    try:
        from .compiler.parser import BOS, EOS, Concat, Lit, Repeat, parse

        node = parse(prog.pattern)
        while isinstance(node, Concat) and len(node.parts) == 1:
            node = node.parts[0]
        if not (
            isinstance(node, Repeat) and node.hi is not None and node.lo >= 1
        ):
            return None

        def has_anchor(nd):
            if isinstance(nd, Lit):
                return BOS in nd.syms or EOS in nd.syms
            parts = getattr(nd, "parts", None) or (
                (nd.child,) if isinstance(nd, Repeat) else ()
            )
            return any(has_anchor(p) for p in parts)

        if has_anchor(node.child):
            return None
        from .compiler.nfa import build_nfa_ast
        from .compiler.program import compile_program

        alias_ast = Repeat(node.child, node.lo, None)
        nfa = build_nfa_ast(alias_ast, f"<seeded-alias:{prog.pattern}>")
        if nfa.nullable or nfa.n_states > 256:
            return None
        if nfa.n_states * 2 > prog.n_states:
            return None  # not actually a blowup collapse
        return compile_program(nfa)
    except Exception:  # pragma: no cover - alias is best-effort
        return None


def relaxed_prefilter_program(prog: DeviceProgram):
    """Tiny superset-language program for hyperscan-style prefiltering of
    the >1024-state (block-sparse) tier, or None.

    Replacing every bounded repeat ``X{m,n}`` with ``X{min(m,4),}``
    relaxes the language to a SUPERSET (a chain of m..n copies is also a
    chain of >= min(m,4) copies when m >= 4), so ``search(P') == False`` proves
    ``search(P) == False`` — and P' collapses the n-fold position blowup
    to a handful of states. The engine scans P' on a small dense tier,
    compacts the (typically rare) candidate records, and runs the
    >1024-state scan only on those. Unlike the seeded alias
    (exact, whole-pattern only) this works with arbitrary context around
    the repeats, because it is only used as a filter."""
    if prog.tier != "sparse" or prog.nullable:
        return None
    from .utils.config import get_config

    if not get_config().sparse_prefilter:
        return None
    try:
        from .compiler.parser import Alt, Concat, Repeat, parse

        changed = []

        def relax(nd):
            if isinstance(nd, Repeat):
                child = relax(nd.child)
                if nd.hi is not None and nd.hi > 1:
                    changed.append(True)
                    # keep up to 4 required copies: a chain of m..n copies
                    # is a chain of >= min(m, 4) copies (superset), and
                    # the extra required copies slash false positives
                    return Repeat(child, min(nd.lo, 4), None)
                return Repeat(child, nd.lo, nd.hi)
            if isinstance(nd, Concat):
                return Concat(tuple(relax(p) for p in nd.parts))
            if isinstance(nd, Alt):
                return Alt(tuple(relax(p) for p in nd.parts))
            return nd

        ast = relax(parse(prog.pattern))
        if not changed:
            return None
        from .compiler.nfa import build_nfa_ast
        from .compiler.program import compile_program

        nfa = build_nfa_ast(ast, f"<prefilter:{prog.pattern}>")
        if nfa.nullable or nfa.n_states > 64:
            return None
        return compile_program(nfa)
    except Exception:  # pragma: no cover - prefilter is best-effort
        return None


class ScanEngine:
    """Per-program engine: holds device tables and exposes scan primitives."""

    def __init__(
        self,
        prog: DeviceProgram,
        backend: Optional[str] = None,
        *,
        accept_map: Optional[np.ndarray] = None,
        channels_per_record: int = 1,
        nullable: Optional[bool] = None,
    ):
        """``accept_map`` ([lanes, C] 0/1) widens the accept reduction to C
        accept channels per packed row (C = G * channels_per_record) — the
        first-class multi-pattern interface (one combined automaton, one
        scan, per-pattern stats). ``nullable`` overrides the kernel-level
        nullability (multi-pattern scans disable it and correct nullable
        channels host-side)."""
        platform.ensure_compile_cache()
        self.prog = prog
        # None = route default (alias and prefilter engines reuse it)
        self.backend_requested = backend
        self.route = platform.route(
            prog, backend, accept_map=accept_map, P=channels_per_record
        )
        self.backend = self.route.backend
        self.tables = sx.device_tables(prog)
        self.n_runs = len(prog.byte_runs[0])
        self.P = channels_per_record
        self._nullable = prog.nullable if nullable is None else nullable
        self._ptables = None
        if self.backend in ("packed", "pallas"):
            from .ops import scan_packed as sp

            self._sp = sp
            self._ptables = sp.packed_tables(prog)
            if accept_map is not None:
                self._ptables = dict(self._ptables)
                self._ptables["A"] = jnp.asarray(accept_map, jnp.bfloat16)
        self._kernel = None
        if self.route.kernel == "word":
            from .ops.scan_word import WordScanner

            self._kernel = WordScanner(
                prog, accept_map=accept_map, P=channels_per_record,
                nullable=nullable,
            )
        elif self.route.kernel == "count":
            from .ops.scan_count import CountScanner, counting_plan

            self._kernel = CountScanner(
                prog, counting_plan(prog), nullable=nullable
            )
        self._accept_map_set = accept_map is not None

    # ------------------------------------------------------------------
    # Seeded-alias routing: X{m,n} == X{m,} under seeded semantics
    # ------------------------------------------------------------------
    def _seeded_alias(self):
        """Cached ScanEngine over ``seeded_alias_program(self.prog)`` (the
        X{m,} alias of a whole-pattern X{m,n} — see that function for the
        semantics argument), or None when no alias applies."""
        built = getattr(self, "_alias_built", False)
        if built:
            return self._alias
        self._alias_built = True
        self._alias = None
        if self.P != 1:
            return None
        aprog = seeded_alias_program(self.prog)
        if aprog is not None:
            self._alias = ScanEngine(aprog, backend=self.backend_requested)
        return self._alias

    @staticmethod
    def _alias_call(alias, name, data, lengths, *args, **kw):
        """Route a call to the seeded-alias engine, rounding B up to the
        alias's packing group with zero-length phantom records (the
        original sparse program has G=1, the alias is lane-packed)."""
        data = jnp.asarray(data)
        lengths = jnp.asarray(lengths)
        G = max(1, alias.prog.G)
        B = data.shape[0]
        Bp = -(-B // G) * G
        if Bp != B:
            data = jnp.pad(data, ((0, Bp - B), (0, 0)))
            lengths = jnp.pad(lengths, (0, Bp - B))
            args = tuple(
                jnp.pad(jnp.asarray(a), (0, Bp - B)) for a in args
            )
        out = getattr(alias, name)(data, lengths, *args, **kw)
        if Bp == B:
            return out
        if isinstance(out, tuple):
            return tuple(o[:B] for o in out)
        return out[:B]

    # ------------------------------------------------------------------
    # Public backend introspection (the supported way for api.py / bench
    # harnesses to reach the device scanner — no private-attr reads)
    # ------------------------------------------------------------------
    @property
    def device_scanner(self):
        """The scanner that serves the match statistics (WordScanner or
        CountScanner), or None when the plain engine serves them."""
        return self._kernel

    @property
    def packed(self) -> bool:
        """True when the engine holds lane-packed tables (dense tiers)."""
        return self._ptables is not None

    # ------------------------------------------------------------------
    # Stream encoding
    # ------------------------------------------------------------------
    def encode(self, data: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
        """[B, T] class-id stream for the unpacked engine."""
        p = self.prog
        return sx.encode_stream(
            self.tables,
            jnp.asarray(data),
            jnp.asarray(lengths),
            p.bos_class,
            p.eos_class,
            p.dead_class,
        )

    def _words(self, data, lengths):
        len_g = self._len_g(lengths)
        words = self._sp.mask_stream_from_bytes(
            self._ptables,
            jnp.asarray(data),
            len_g,
            s_tile=self.prog.s_tile,
            G=self.prog.G,
            n_runs=self.n_runs,
        )
        return words, len_g

    def _len_g(self, lengths: jnp.ndarray) -> jnp.ndarray:
        return jnp.asarray(lengths).reshape(-1, self.prog.G)

    def _len_channels(self, lengths: jnp.ndarray) -> jnp.ndarray:
        """Per-accept-channel lengths (== per record unless multi-pattern)."""
        len_g = self._len_g(lengths)
        if self.P == 1:
            return len_g
        return jnp.repeat(len_g, self.P, axis=1)

    # ------------------------------------------------------------------
    # Primitives (all take/return device arrays)
    # ------------------------------------------------------------------
    def forward_flags(self, data, lengths, *, seeded: bool) -> jnp.ndarray:
        """[B, T+1] accept flags."""
        alias = self._seeded_alias()
        if seeded and alias is not None:
            return self._alias_call(
                alias, "forward_flags", data, lengths, seeded=True
            )
        if self._use_prefilter(data):
            # prefilter rejection proves no seeded accept anywhere;
            # unseeded accepts are a subset of seeded ones
            return self._prefilter_apply(
                data, lengths,
                lambda d, l: self._forward_flags_raw(d, l, seeded),
                fills=(False,),
            )
        return self._forward_flags_raw(data, lengths, seeded)

    def _forward_flags_raw(self, data, lengths, seeded: bool):
        if self.route.kernel == "count":
            return self._kernel.forward_flags_b(
                data, self._len_g(lengths), seeded=seeded
            )
        if self._ptables is not None:
            words, _ = self._words(data, lengths)
            return self._sp.forward_flags(
                self._ptables, words, seeded=seeded, lanes=self.prog.lanes
            )
        cls = self.encode(data, lengths)
        return sx.forward_flags(self.tables, cls, seeded=seeded, n_seed_steps=2)

    def _window_plan(self, L: int, B: int, seeded: bool):
        """(k, w, h) record window split for the batched word scan, or None.

        Tall-narrow batches (few records x long records) underfill the
        kernel's record blocks; splitting each record into ``k`` windows
        of ``w`` owned bytes plus an ``h``-byte warm-up overlap (scanned
        with ``lead=h`` so overlap accepts are suppressed) multiplies the
        batch width by k at a +h/w byte cost. Exact for (cnt, first, any)
        when every match fits in ``h = prog.horizon`` bytes, the pattern is
        anchor-free (BOS/EOS symbols inert, so per-window injection is a
        no-op) and non-nullable (no empty match at every position)."""
        from .utils.config import get_config

        p = self.prog
        if (
            not seeded
            or self.route.kernel != "word"
            or self.P != 1
            or self._nullable
            or p.nullable
            or p.uses_anchor
        ):
            return None
        h = p.horizon
        if h is None or h > 128:
            return None
        w_min = max(128, 4 * h)
        target = get_config().window_cols
        if not target or L < 2 * w_min:
            return None
        k = min(L // w_min, -(-target // max(1, B)))
        if k < 2:
            return None
        w = -(-L // k)
        k = -(-L // w)
        return (k, w, h) if k >= 2 else None

    def _match_stats_windowed(self, data, lengths, k: int, w: int, h: int):
        """Windowed (cnt, first, any): split [B, L] records into [B*k, w+h]
        overlapped windows (front-padded with 0xFF, a dead byte for ASCII
        programs), scan with lead=h, and reduce per record."""
        data = jnp.asarray(data)
        B, L = data.shape
        dp = jnp.pad(
            data, ((0, 0), (h, k * w - L)), constant_values=np.uint8(0xFF)
        )
        win = jnp.stack(
            [dp[:, j * w : j * w + w + h] for j in range(k)], axis=1
        ).reshape(B * k, w + h)
        off = jnp.arange(k, dtype=jnp.int32)[None, :] * w
        ln = jnp.clip(
            jnp.asarray(lengths, jnp.int32)[:, None] + h - off, 0, w + h
        )  # [B, k] window-local lengths
        cnt, first, last, full, anym = self._kernel.match_stats_b(
            win, ln.reshape(-1, 1), seeded=True, lead=h
        )
        cnt = cnt.reshape(B, k)
        first = first.reshape(B, k)
        big = jnp.int32(1 << 30)
        fg = jnp.where(first >= 0, first - h + off, big)
        fmin = jnp.min(fg, axis=1)
        cnt_rec = cnt.sum(axis=1)
        return cnt_rec, jnp.where(fmin >= big, -1, fmin), cnt_rec > 0

    def match_stats(self, data, lengths, *, seeded: bool):
        """(count, first_end, any) per accept channel (== per record unless
        multi-pattern), each flattened to [B * channels_per_record]."""
        alias = self._seeded_alias()
        if seeded and alias is not None:
            return self._alias_call(
                alias, "match_stats", data, lengths, seeded=True
            )
        if seeded and jnp.asarray(data).shape[0] > 128:
            pf = self._prefilter()
            if pf is not None:
                return self._match_stats_prefiltered(data, lengths)
        return self._match_stats_raw(data, lengths, seeded=seeded)

    def _prefilter(self):
        """Lazily built prefilter engine (relaxed_prefilter_program), or
        None. Only pays off against the >1024-state scan: counting-tier
        programs are already one int32 per record, and small batches
        (B <= the compaction bucket floor) skip it entirely."""
        if getattr(self, "_prefilter_built", False):
            return self._prefilter_eng
        self._prefilter_built = True
        self._prefilter_eng = None
        if (
            self.P == 1
            and not self._accept_map_set
            and self.route.kernel != "count"
            and self.prog.tier == "sparse"
            and seeded_alias_program(self.prog) is None
        ):
            rp = relaxed_prefilter_program(self.prog)
            if rp is not None:
                self._prefilter_eng = ScanEngine(
                    rp, backend=self.backend_requested
                )
        return self._prefilter_eng

    def _match_stats_prefiltered(self, data, lengths):
        """Two-phase sparse scan: a tiny superset-language scan finds
        candidate records (relaxed_prefilter_program), the heavy scan
        runs on a compacted candidate batch, and results scatter back —
        all traceable (lax.cond picks the full scan when the candidate
        count exceeds the static compaction bucket, so the result is
        exact either way)."""
        return self._prefilter_apply(
            data,
            lengths,
            lambda d, l: self._match_stats_raw(d, l, seeded=True),
            fills=(0, -1, False),
        )

    def _prefilter_apply(self, data, lengths, raw_fn, *, fills, extra=()):
        """Generic prefilter compaction: run ``raw_fn(data2, lengths2,
        *extra2)`` on the candidate-compacted batch and scatter each
        output back along axis 0 with the matching ``fills`` value (the
        exact result for a record the superset scan rejects). ``extra``
        = ((per-record array, gather fill), ...) forwarded to raw_fn.
        Falls through to the raw call when no prefilter applies or the
        batch is too small to compact.

        TWO static bucket sizes (~B/16 and ~B/4, each >= 128 rows and
        picked at runtime by candidate count under nested lax.cond) so
        the filter's leverage scales with hit density: a single B/4
        bucket caps the speedup at 4x the raw scan no matter how sparse
        the hits; the small bucket lifts <= ~6% densities to ~16x. Each
        bucket compiles its own raw_fn geometry."""
        data = jnp.asarray(data)
        lengths = jnp.asarray(lengths)
        ex_arrays = tuple(jnp.asarray(a) for (a, _f) in extra)
        B = data.shape[0]
        buckets = []
        for div in (16, 4):
            b = min(B, max(128, -(-(B // div) // 128) * 128))
            if b < B and b not in buckets:
                buckets.append(b)
        if not buckets:  # static: nothing to gain, skip the filter scan
            return raw_fn(data, lengths, *ex_arrays)
        _, _, pre_any = self._alias_call(
            self._prefilter_eng, "match_stats", data, lengths, seeded=True
        )
        pre_any = pre_any.reshape(-1)[:B]
        nhits = jnp.sum(pre_any.astype(jnp.int32))

        def compact_at(bcap):
            def compacted(_):
                (idx,) = jnp.nonzero(pre_any, size=bcap, fill_value=0)
                valid = jnp.arange(bcap) < nhits
                d2 = jnp.take(data, idx, axis=0)
                l2 = jnp.where(valid, jnp.take(lengths, idx), 0)
                ex2 = tuple(
                    jnp.where(
                        valid, jnp.take(a, idx), jnp.asarray(f, a.dtype)
                    )
                    for a, (_a, f) in zip(ex_arrays, extra)
                )
                outs = raw_fn(d2, l2, *ex2)
                single = not isinstance(outs, tuple)
                outs_t = (outs,) if single else outs
                # drop invalid compaction slots (they all alias record 0)
                safe = jnp.where(valid, idx, B)
                res = []
                for o, f in zip(outs_t, fills):
                    base = jnp.full((B,) + o.shape[1:], f, o.dtype)
                    res.append(base.at[safe].set(o, mode="drop"))
                return res[0] if single else tuple(res)

            return compacted

        def full(_):
            return raw_fn(data, lengths, *ex_arrays)

        nxt = full
        for b in sorted(buckets, reverse=True):
            def nxt(_, b=b, inner=nxt):
                return jax.lax.cond(nhits <= b, compact_at(b), inner, None)

        return nxt(None)

    def _use_prefilter(self, data) -> bool:
        return (
            jnp.asarray(data).shape[0] > 128 and self._prefilter() is not None
        )

    def _match_stats_raw(self, data, lengths, *, seeded: bool):
        if self._kernel is not None:
            data = jnp.asarray(data)
            plan = self._window_plan(data.shape[1], data.shape[0], seeded)
            if plan is not None:
                return self._match_stats_windowed(data, lengths, *plan)
            cnt, first, last, full, anym = self._kernel.match_stats_b(
                data, self._len_g(lengths), seeded=seeded
            )
            B = cnt.shape[0] * cnt.shape[1]
            return cnt.reshape(B), first.reshape(B), anym.reshape(B)
        if self._ptables is not None:
            words, _ = self._words(data, lengths)
            len_c = self._len_channels(lengths)
            cnt, first, anym = self._sp.match_stats(
                self._ptables,
                words,
                len_c,
                seeded=seeded,
                nullable=self._nullable,
                lanes=self.prog.lanes,
            )
            B = cnt.shape[0] * cnt.shape[1]
            return cnt.reshape(B), first.reshape(B), anym.reshape(B)
        cls = self.encode(data, lengths)
        return sx.match_stats(
            self.tables, cls, jnp.asarray(lengths), seeded=seeded,
            nullable=self.prog.nullable,
        )

    def window_stats(self, data, lengths, *, lead: int):
        """Seeded (count, first_end, any) per record of an overlapped-window
        batch (ops/longstring.FastLongScanner): accepts at steps <= lead
        belong to the previous window and are dropped. Single-channel,
        dense tiers."""
        if self._kernel is not None:
            cnt, first, _, _, anym = self._kernel.match_stats_b(
                data, self._len_g(lengths), seeded=True, lead=lead
            )
        else:
            words, len_g = self._words(data, lengths)
            cnt, first, anym = self._sp.match_stats(
                self._ptables, words, len_g, seeded=True,
                nullable=self._nullable, lanes=self.prog.lanes, lead=lead,
            )
        return cnt.reshape(-1), first.reshape(-1), anym.reshape(-1)

    def reverse_hits(self, data, lengths) -> jnp.ndarray:
        """[B, T] start-position hits."""
        alias = self._seeded_alias()
        if alias is not None:
            return self._alias_call(alias, "reverse_hits", data, lengths)
        if self._use_prefilter(data):
            # a record the superset scan rejects has no match, hence no
            # start positions
            return self._prefilter_apply(
                data, lengths, self._reverse_hits_raw, fills=(False,)
            )
        return self._reverse_hits_raw(data, lengths)

    def _reverse_hits_raw(self, data, lengths):
        if self.route.kernel == "count":
            return self._kernel.reverse_hits_b(data, self._len_g(lengths))
        if self._ptables is not None:
            words, _ = self._words(data, lengths)
            return self._sp.reverse_hits(
                self._ptables, words, lanes=self.prog.lanes
            )
        cls = self.encode(data, lengths)
        return sx.reverse_hits(self.tables, cls)

    def first_end_from(self, data, lengths, starts, *, longest: bool = False):
        """Anchored-rescan end per record (-1 = none): smallest end (lazy
        policy) or, with ``longest=True``, largest end (greedy
        leftmost-longest -- the POSIX policy)."""
        alias = self._seeded_alias()
        if not longest and alias is not None:
            # lazy first-end from an anchored start: the shortest chain
            # is m copies for X{m,n} and X{m,} alike. Greedy (longest)
            # rescans observe the n bound — they stay on the original.
            return self._alias_call(
                alias, "first_end_from", data, lengths, starts,
                longest=False,
            )

        def raw(d, l, st):
            if self._ptables is not None:
                words, len_g = self._words(d, l)
                first = self._sp.first_end_from(
                    self._ptables,
                    words,
                    len_g,
                    jnp.asarray(st).reshape(-1, self.prog.G),
                    lanes=self.prog.lanes,
                    s_tile=self.prog.s_tile,
                    longest=longest,
                )
                return first.reshape(-1)
            cls = self.encode(d, l)
            return sx.first_end_from(
                self.tables, cls, jnp.asarray(l), jnp.asarray(st),
                longest=longest,
            )

        if self._use_prefilter(data):
            # no match in the record implies no anchored end either
            return self._prefilter_apply(
                data, lengths, raw, fills=(-1,), extra=((starts, -1),),
            )
        return raw(jnp.asarray(data), jnp.asarray(lengths), starts)

    # ------------------------------------------------------------------
    # Device-side span enumeration
    # ------------------------------------------------------------------
    @property
    def device_spans(self) -> bool:
        """True when spans enumerate on device (route choice)."""
        return self.route.device_spans

    def spans(self, data, lengths, *, cap: int, longest: bool = False):
        """(starts [B, cap], ends [B, cap], count [B], overflow [B]) —
        non-overlapping lazy or greedy spans as ONE device program over
        this engine's own primitives (scan_xla.spans_rounds: the reverse
        scan, then a while_loop of anchored rescans). ``count`` is exact;
        ``overflow`` marks records with more than ``cap`` spans."""
        return self._spans(
            jnp.asarray(data), jnp.asarray(lengths), cap=cap, longest=longest
        )

    @functools.partial(jax.jit, static_argnames=("self", "cap", "longest"))
    def _spans(self, data, lengths, *, cap: int, longest: bool):
        return sx.spans_rounds(
            self.reverse_hits(data, lengths),
            lengths,
            lambda s: self.first_end_from(data, lengths, s, longest=longest),
            cap=cap, longest=longest, nullable=self.prog.nullable,
            max_len=int(data.shape[1]),
        )

    # ------------------------------------------------------------------
    # Bitmaps
    # ------------------------------------------------------------------
    @staticmethod
    def _fetch_bitmap(bm) -> np.ndarray:
        """Device [B, W] bool -> host bool array via device-side bit
        packing: 8x less device->host traffic."""
        W = bm.shape[1]
        packed = np.asarray(jnp.packbits(bm.astype(jnp.uint8), axis=1))
        return np.unpackbits(packed, axis=1)[:, :W].astype(bool)

    def ends_bitmap(self, data, lengths, max_len: int) -> np.ndarray:
        alias = self._seeded_alias()
        if alias is not None:
            return self._alias_call(
                alias, "ends_bitmap", data, lengths, max_len=max_len
            )
        flags = self.forward_flags(data, lengths, seeded=True)
        return self._fetch_bitmap(
            sx.ends_bitmap(
                flags, jnp.asarray(lengths), max_len, self.prog.nullable,
                seeded=True,
            )
        )

    def starts_bitmap(self, data, lengths, max_len: int) -> np.ndarray:
        alias = self._seeded_alias()
        if alias is not None:
            return self._alias_call(
                alias, "starts_bitmap", data, lengths, max_len=max_len
            )
        hits = self.reverse_hits(data, lengths)
        return self._fetch_bitmap(
            sx.starts_bitmap(
                hits, jnp.asarray(lengths), max_len, self.prog.nullable
            )
        )

    def fullmatch_flags(self, data, lengths) -> np.ndarray:
        """[B] bool whole-string acceptance (the reference's only matching
        semantics, regex.h:150-165). With a match-statistics scanner this
        is one unseeded stats pass (no [B, T] flag stream)."""
        if self._kernel is not None:
            _, _, _, full, _ = self._kernel.match_stats_b(
                jnp.asarray(data), self._len_g(lengths), seeded=False
            )
            return np.asarray(full.reshape(-1))

        def raw(d, l):
            flags = self._forward_flags_raw(d, l, False)
            T1 = flags.shape[1]
            t = jnp.arange(T1)[None, :]
            n = jnp.asarray(l)[:, None]
            e = jnp.clip(t - 1, 0, n)
            covers = (jnp.maximum(t - 1, 0) >= n) | (n == 0)
            return (flags & (e == n) & covers).any(axis=1)

        if self._use_prefilter(data):
            # prefilter rejection (a seeded-superset fact) rules out the
            # anchored whole-string match too
            return np.asarray(
                self._prefilter_apply(data, lengths, raw, fills=(False,))
            )
        return np.asarray(raw(jnp.asarray(data), jnp.asarray(lengths)))
