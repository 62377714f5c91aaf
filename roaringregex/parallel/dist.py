"""Distributed scan runtime: data-parallel corpus sharding over a device mesh.

The reference is single-process, single-core (SURVEY.md §1: "no scheduler, no
multi-thread/multi-process layer"); this layer is the capability BASELINE.json
demands instead: the corpus shards over a 1-D ``data`` mesh axis, compiled NFA
tables are **replicated** on every chip (broadcast once at engine build), the
per-shard scan runs under ``shard_map``, and scalar match statistics are
reduced with ``psum`` so every device (and host) sees the global counts. XLA
inserts the collectives from the sharding annotations (NCCL over NVLink
between the cards of one host); there is no hand-written transport.

Multi-host bring-up uses ``jax.distributed.initialize()`` (see
``init_multihost``); single-host multi-chip and the CPU-mesh test harness
(``--xla_force_host_platform_device_count=N``) go through the same code path.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import platform
from ..compiler.program import DeviceProgram
from ..ops import scan_packed as spk
from ..ops import scan_xla as sx

DATA_AXIS = "data"


def _halo_buf(own, tail, *, C: int, H: int, D: int, axis: str):
    """Halo exchange for a contiguous-chunk sharded stream.

    ``own`` is this device's [C]-byte chunk of a global stream laid out as
    D contiguous chunks + a replicated [H] ``tail`` (positions D*C..D*C+H).
    Returns the [C+H] slice starting at this device's global offset: the
    lookahead bytes are fetched from the right neighbours with
    ``lax.ppermute`` — per-device
    HBM stays O(n/D + H) instead of the O(n) a replicated stream costs.
    Positions past the end of the chunked region fall back to ``tail``.
    """
    parts = [own]
    k = -(-H // C) if C else 0
    for i in range(1, k + 1):
        hs = min(C, H - (i - 1) * C)
        perm = [(s, (s - i) % D) for s in range(D)]
        parts.append(jax.lax.ppermute(own[:hs], axis, perm))
    buf = jnp.concatenate(parts)[: C + H] if parts[1:] else own[: C + H]
    idx = jax.lax.axis_index(axis).astype(jnp.int32)
    g = idx * C + jnp.arange(C + H, dtype=jnp.int32)
    wrap = jnp.clip(g - D * C, 0, max(H - 1, 0))
    if H == 0:
        return buf
    return jnp.where(g < D * C, buf, tail[wrap])


def init_multihost(coordinator: Optional[str] = None, **kw) -> None:
    """Initialize jax.distributed for a multi-host run; fail fast on error
    (SURVEY.md §5: minimum failure-detection requirement)."""
    try:
        if coordinator is not None:
            jax.distributed.initialize(coordinator_address=coordinator, **kw)
        else:
            jax.distributed.initialize(**kw)
    except Exception as e:  # pragma: no cover - env dependent
        raise RuntimeError(f"jax.distributed init failed: {e}") from e


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> Mesh:
    """A 1-D data mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(
    mesh: Mesh, data: np.ndarray, lengths: np.ndarray, axis: str = DATA_AXIS
) -> Tuple[jax.Array, jax.Array]:
    """Place a packed [B, L] batch sharded over the data axis (B must divide
    evenly; callers pad B to a multiple of mesh size)."""
    ds = NamedSharding(mesh, P(axis, None))
    ls = NamedSharding(mesh, P(axis))
    return jax.device_put(data, ds), jax.device_put(lengths, ls)


class DistScanner:
    """Mesh-wide scanner: replicated tables, sharded records, psum'd stats.

    Owns jit caches for the shard_map'd scan functions. All entry points
    take **raw [B, L] uint8 byte batches** plus lengths; the byte->mask
    translation runs sharded on device (fused into the word kernel, via
    mask_stream_from_bytes on the packed path).
    """

    def __init__(
        self,
        prog: DeviceProgram,
        mesh: Mesh,
        axis: str = DATA_AXIS,
        *,
        accept_map=None,
        channels_per_record: int = 1,
        nullable: Optional[bool] = None,
        backend: Optional[str] = None,
    ):
        """``accept_map`` / ``channels_per_record`` mirror ScanEngine's
        first-class multi-pattern interface: C = G*P accept channels per
        packed row, per-record-per-pattern stats from one sharded scan.
        The per-shard scan path is ``platform.route``'s choice, as for
        ScanEngine."""
        self.prog = prog
        self.mesh = mesh
        self.axis = axis
        self.n_runs = len(prog.byte_runs[0])
        self.dense = prog.tier != "sparse"
        self._has_accept_map = accept_map is not None
        self.P = channels_per_record
        self._nullable = prog.nullable if nullable is None else nullable
        self.backend_requested = backend
        tables = spk.packed_tables(prog) if self.dense else sx.device_tables(prog)
        if accept_map is not None and self.dense:
            tables = dict(tables)
            tables["A"] = jnp.asarray(accept_map, jnp.bfloat16)
        self.route = platform.route(
            prog, backend, accept_map=accept_map, P=channels_per_record
        )
        self._plk = None
        if self.route.kernel == "word":
            from ..ops.scan_word import WordScanner

            self._plk = WordScanner(
                prog, accept_map=accept_map, P=channels_per_record,
                nullable=nullable,
            )
        elif self.route.kernel == "count":
            from ..ops.scan_count import CountScanner, counting_plan

            # run-length tier: X{m,n} scans with no follow matmul
            self._plk = CountScanner(
                prog, counting_plan(prog), nullable=nullable
            )
        # replicate tables on every chip (broadcast once, like the
        # "transition tables replicated" requirement of BASELINE config 5)
        rep = NamedSharding(mesh, P())
        self.tables = jax.tree.map(lambda x: jax.device_put(x, rep), tables)
        self._spec_in = P(axis, None)
        self._spec_v = P(axis)

    def _local_stats(self, tables, d, l, seeded):
        """Per-shard (count, first, any): the packed gather-free path on
        dense tiers, unpacked fallback on the sparse tier."""
        prog = self.prog
        if self.route.kernel == "count":
            # counting tier: one int32 run counter per record, any B
            cnt, first, _, _, anym = self._plk.match_stats_b(
                d, l.reshape(-1, 1), seeded=seeded
            )
            B0c = d.shape[0]
            return (
                cnt.reshape(-1)[:B0c],
                first.reshape(-1)[:B0c],
                anym.reshape(-1)[:B0c],
            )
        if self.dense:
            # pad the local shard to a packing-group multiple (zero-length
            # phantom records; sliced off before any reduction)
            B0, G = d.shape[0], prog.G
            Bp = ((B0 + G - 1) // G) * G
            if Bp != B0:
                d = jnp.pad(d, ((0, Bp - B0), (0, 0)))
                l = jnp.pad(l, (0, Bp - B0))
            len_g = l.reshape(-1, G)
            if self._plk is not None:
                # word kernel: byte->gate compares fused in the kernel
                cnt, first, _, _, anym = self._plk.match_stats_b(
                    d, len_g, seeded=seeded
                )
            else:
                words = spk.mask_stream_from_bytes(
                    tables, d, len_g, s_tile=prog.s_tile, G=prog.G,
                    n_runs=self.n_runs,
                )
                len_c = (
                    jnp.repeat(len_g, self.P, axis=1) if self.P > 1 else len_g
                )
                cnt, first, anym = spk.match_stats(
                    tables, words, len_c, seeded=seeded,
                    nullable=self._nullable, lanes=prog.lanes,
                )
            B = cnt.shape[0] * cnt.shape[1]
            B0c = B0 * self.P
            return (
                cnt.reshape(B)[:B0c],
                first.reshape(B)[:B0c],
                anym.reshape(B)[:B0c],
            )
        cls = sx.encode_stream(
            tables, d, l, prog.bos_class, prog.eos_class, prog.dead_class
        )
        return sx.match_stats(
            tables, cls, l, seeded=seeded, nullable=prog.nullable
        )

    # ------------------------------------------------------------------
    def global_stats(
        self, data: jax.Array, lengths: jax.Array, *, seeded: bool = True
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Global (total_matches, total_matched_records, total_bytes) from a
        sharded raw-byte batch: the psum-reduced scalar statistics of
        BASELINE config 5. Returned arrays are fully replicated scalars."""
        if seeded:
            ad = self._alias_dist()
            if ad is not None:
                return ad.global_stats(data, lengths, seeded=True)

        @functools.partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(P(), self._spec_in, self._spec_v),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
        def _stats(tables, d, l):
            cnt, _, anym = self._local_stats(tables, d, l, seeded)
            total = jax.lax.psum(jnp.sum(cnt), self.axis)
            nrec = jax.lax.psum(jnp.sum(anym.astype(jnp.int32)), self.axis)
            nbytes = jax.lax.psum(jnp.sum(l), self.axis)
            return total, nrec, nbytes

        return _stats(self.tables, data, lengths)

    # ------------------------------------------------------------------
    # Sharded out-of-core streaming (BASELINE config 5's 10 GB story:
    # the corpus streams host->devices sharded over the data axis with
    # depth-K chunks in flight, tables replicated once, per-chunk psum'd
    # scalars accumulated on device and gathered once at stream end)
    # ------------------------------------------------------------------
    def _stream_stats_fn(self):
        fn = getattr(self, "_stream_fn", None)
        if fn is None:

            @jax.jit
            @functools.partial(
                jax.shard_map,
                mesh=self.mesh,
                in_specs=(P(), self._spec_in, self._spec_v),
                out_specs=P(),
                check_vma=False,
            )
            def _stats(tables, d, l):
                cnt, _, anym = self._local_stats(tables, d, l, True)
                return jnp.stack([
                    jax.lax.psum(jnp.sum(cnt, dtype=jnp.int32), self.axis),
                    jax.lax.psum(
                        jnp.sum(anym.astype(jnp.int32)), self.axis
                    ),
                    jax.lax.psum(jnp.sum(l, dtype=jnp.int32), self.axis),
                ])

            fn = self._stream_fn = functools.partial(_stats, self.tables)
        return fn

    def stats_stream(self, batches, *, depth: int = 3):
        """Streamed grep -c over the WHOLE mesh: each chunk is uploaded
        sharded over the data axis (per-device bytes ~= chunk/D), scanned
        under shard_map with psum'd scalars, with up to ``depth`` chunks
        in flight — the mesh analog of stream.StreamScanner.stats_stream.
        Accepts (data, lengths) or (data, lengths, n_real) batches; rows
        are padded to a multiple of D * G with zero-length phantoms.
        Single-accept-channel engines only (P == 1)."""
        import collections

        from ..stream import StreamStats

        assert self.P == 1, "sharded streaming is single-channel"
        ad = self._alias_dist()
        if ad is not None:
            return ad.stats_stream(batches, depth=depth)
        fn = self._stream_stats_fn()
        D = int(np.prod([self.mesh.shape[a] for a in self.mesh.axis_names]))
        G = max(1, self.prog.G)
        q = D * G
        shard_d = NamedSharding(self.mesh, P(self.axis, None))
        shard_l = NamedSharding(self.mesh, P(self.axis))
        outs = []
        live = collections.deque()
        n_real = 0
        n_pad = 0
        self.last_stream_shard_rows = None
        for batch in batches:
            if len(batch) == 3:
                data, lengths, nr = batch
            else:
                data, lengths = batch
                nr = int(np.asarray(data).shape[0])
            data = np.asarray(data)
            lengths = np.asarray(lengths, np.int32)
            B = data.shape[0]
            Bp = -(-B // q) * q
            if Bp != B:
                data = np.concatenate(
                    [data, np.zeros((Bp - B, data.shape[1]), np.uint8)]
                )
                lengths = np.concatenate(
                    [lengths, np.zeros(Bp - B, np.int32)]
                )
            d = jax.device_put(jnp.asarray(data), shard_d)
            l = jax.device_put(jnp.asarray(lengths), shard_l)
            # per-device placement really is chunk/D rows (asserted by
            # dryrun_multichip on the virtual mesh)
            self.last_stream_shard_rows = Bp // D
            out = fn(d, l)
            outs.append(out)
            live.append(out)
            n_real += int(nr)
            n_pad += Bp - int(nr)
            if len(live) >= max(1, depth):
                jax.block_until_ready(live.popleft())
        if live:
            jax.block_until_ready(list(live))
        if not outs:
            return StreamStats(0, 0, 0, 0, 0)
        packed = np.asarray(jnp.stack(outs))  # [chunks, 3], one gather
        total, nrec, nbytes = packed.sum(axis=0, dtype=np.int64)
        if self._nullable:
            # kernels count each phantom pad row as 1 empty match + 1
            # matched record (same correction as StreamScanner)
            total -= n_pad
            nrec -= n_pad
        return StreamStats(
            int(total), int(nrec), n_real, int(nbytes), len(outs)
        )

    # ------------------------------------------------------------------
    def per_record(
        self, data: jax.Array, lengths: jax.Array, *, seeded: bool = True
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """Sharded per-record (count, first_end, any) — stays sharded for
        downstream span extraction on the owning chip."""
        if seeded:
            ad = self._alias_dist()
            if ad is not None:
                return ad.per_record(data, lengths, seeded=True)

        @functools.partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(P(), self._spec_in, self._spec_v),
            out_specs=(self._spec_v, self._spec_v, self._spec_v),
            check_vma=False,
        )
        def _pr(tables, d, l):
            return self._local_stats(tables, d, l, seeded)

        return _pr(self.tables, data, lengths)

    # ------------------------------------------------------------------
    def grep_hits(self, data: jax.Array, lengths: jax.Array) -> jax.Array:
        """[B] bool, sharded: record contains a match."""
        _, _, anym = self.per_record(data, lengths, seeded=True)
        return anym

    # ------------------------------------------------------------------
    def per_record_spans(
        self,
        data: jax.Array,
        lengths: jax.Array,
        *,
        cap: int,
        longest: bool = False,
    ):
        """Sharded non-overlapping span extraction: each shard enumerates
        its records' spans on its own chip (reverse pass + device-side
        anchored-rescan rounds; no cross-chip traffic — spans stay with
        the record's owner). Returns sharded (starts [B, cap],
        ends [B, cap], count [B], overflow [B]). Dense tiers — X{m,n}
        blowups route their LAZY extraction through the seeded alias
        (identical lazy spans; greedy observes the bound and needs the
        original tier)."""
        if not longest:
            ad = self._alias_dist()
            if ad is not None:
                return ad.per_record_spans(
                    data, lengths, cap=cap, longest=False
                )
        assert self.dense, "sharded spans need a dense tier"
        assert self.P == 1, "span extraction is single-pattern"
        prog = self.prog
        max_len = int(data.shape[1])

        @functools.partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(P(), self._spec_in, self._spec_v),
            out_specs=(
                self._spec_in, self._spec_in, self._spec_v, self._spec_v,
            ),
            check_vma=False,
        )
        def _spans(tables, d, l):
            B0, G = d.shape[0], prog.G
            Bp = ((B0 + G - 1) // G) * G
            if Bp != B0:
                d = jnp.pad(d, ((0, Bp - B0), (0, 0)))
                l = jnp.pad(l, (0, Bp - B0))
            len_g = l.reshape(-1, G)
            words = spk.mask_stream_from_bytes(
                tables, d, len_g, s_tile=prog.s_tile, G=prog.G,
                n_runs=self.n_runs,
            )
            s, e, cnt, over = sx.spans_rounds(
                spk.reverse_hits(tables, words, lanes=prog.lanes),
                len_g.reshape(-1),
                lambda st: spk.first_end_from(
                    tables, words, len_g, st.reshape(-1, G),
                    lanes=prog.lanes, s_tile=prog.s_tile, longest=longest,
                ).reshape(-1),
                cap=cap, longest=longest, nullable=prog.nullable,
                max_len=max_len,
            )
            return s[:B0], e[:B0], cnt[:B0], over[:B0]

        return _spans(self.tables, data, lengths)

    # ------------------------------------------------------------------
    # Long-string mode: ONE string sharded across the mesh
    # ------------------------------------------------------------------
    def long_flags(
        self, text_bytes, *, block: int = 4096, seeded: bool = True
    ) -> np.ndarray:
        """Block-parallel scan of one long string with the blocks sharded
        over the data axis — ONE jitted SPMD program end to end:

        1. per-shard block summaries (affine (M, s) pairs) — parallel, no
           communication;
        2. ``lax.all_gather`` of the tiny [nb, S, S] summary tensor (the
           only data that crosses devices) + replicated associative prefix
           combine;
        3. each shard slices its blocks' entry states and replays — no
           host round trip between stages, one dispatch total.

        Returns flags [T = len+2] (the ops/longstring.py convention).

        The raw byte stream is **sharded** over the data axis (each device
        holds only its nb/D blocks ≈ n/D bytes) and the BOS/EOS/dead class
        encoding runs *inside* the SPMD program on each shard's own blocks
        — no replicated O(n) array exists at any point.
        """
        import numpy as _np

        from ..ops import longstring as ls

        prog = self.prog
        tables = ls.compact_tables(prog) if self.dense else self.tables
        n = len(text_bytes)
        T = n + 2
        D = self.mesh.devices.size
        nb = -(-T // block)
        nb = ((nb + D - 1) // D) * D  # block count divisible by mesh size
        rb = _np.zeros(nb * block, dtype=_np.uint8)
        rb[1 : 1 + n] = _np.frombuffer(bytes(text_bytes), dtype=_np.uint8)
        first_gate = (jnp.arange(nb) == 0).astype(jnp.float32)
        shard2 = NamedSharding(self.mesh, P(self.axis, None))
        shard1 = NamedSharding(self.mesh, P(self.axis))
        rb_sharded = jax.device_put(rb.reshape(nb, block), shard2)
        # no halo: summary blocks are non-overlapping (per-device = n/D)
        self.last_stream_geom = (
            (nb // D) * block,
            0,
            rb_sharded.sharding.shard_shape(rb_sharded.shape),
        )
        fg_sharded = jax.device_put(first_gate, shard1)
        tb_rep = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(self.mesh, P())), tables
        )
        s_pad = int(tables["accept"].shape[0])
        flags_b = self._long_flags_spmd(
            tb_rep, rb_sharded, fg_sharded, s_pad=s_pad, seeded=seeded, n=n
        )
        return np.asarray(flags_b).reshape(-1)[:T]

    @functools.partial(
        jax.jit, static_argnames=("self", "s_pad", "seeded", "n")
    )
    def _long_flags_spmd(self, tables, rb_b, first_gate, *, s_pad, seeded, n):
        from ..ops import longstring as ls

        axis = self.axis
        prog = self.prog

        @functools.partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(P(), self._spec_in, self._spec_v),
            out_specs=self._spec_in,
            check_vma=False,
        )
        def _go(tb, rb, fg):
            nb_l, blk = rb.shape
            # in-shard class encoding: byte->class gather + BOS/EOS/dead
            # sentinels by global stream position (stream layout: BOS at
            # position 0, bytes at 1..n, EOS at n+1, dead filler after)
            off = jax.lax.axis_index(axis).astype(jnp.int32) * (nb_l * blk)
            pos = off + jnp.arange(nb_l * blk, dtype=jnp.int32).reshape(
                nb_l, blk
            )
            cls = jnp.take(tb["byte_class"], rb.astype(jnp.int32), axis=0)
            cb = jnp.where(
                pos == 0,
                prog.bos_class,
                jnp.where(
                    pos == n + 1,
                    prog.eos_class,
                    jnp.where(pos > n + 1, prog.dead_class, cls),
                ),
            )
            Ms, ss = ls.block_summaries(tb, cb, fg, s_pad=s_pad, seeded=seeded)
            Ms_all = jax.lax.all_gather(Ms, axis, tiled=True)  # [nb, S, S]
            ss_all = jax.lax.all_gather(ss, axis, tiled=True)  # [nb, S]
            ventry = ls.prefix_entries(Ms_all, ss_all)  # replicated compute
            idx = jax.lax.axis_index(axis)
            ve_local = jax.lax.dynamic_slice_in_dim(
                ventry, idx * nb_l, nb_l, 0
            )
            return ls.block_replay(tb, cb, ve_local, fg, seeded=seeded)

        return _go(tables, rb_b, first_gate)

    def long_count(self, text_bytes, *, block: int = 4096) -> int:
        """Distinct match-end positions in one sharded long string."""
        ad = self._alias_dist()
        if ad is not None:
            return ad.long_count(text_bytes, block=block)
        n = len(text_bytes)
        flags = self.long_flags(text_bytes, block=block, seeded=True)
        e = np.clip(np.arange(n + 2), 0, n)
        out = np.zeros(n + 1, bool)
        np.maximum.at(out, e, flags[: n + 2] > 0)
        if self.prog.nullable:
            out[:] = True
        return int(out.sum())

    # -- sharded long string (overlapped windows) --------------------------
    def _long_count_scanner(self):
        """CountLongScanner for the sharded run-length window path, or
        None when the pattern has no counting plan (mirrors the
        make_long_scanner routing)."""
        cls = getattr(self, "_cls", None)
        if cls is None:
            from ..ops.longstring import CountLongScanner
            from ..ops.scan_count import counting_plan

            plan = counting_plan(self.prog)
            cls = False
            if (
                plan is not None
                and max(plan[0], 1) * len(plan[2][0]) <= 1 << 16
            ):
                cls = CountLongScanner(self.prog, plan)
            self._cls = cls
        return cls or None

    def _long_fast_scanner(self):
        """FastLongScanner for the overlapped sharded path, or None when
        the pattern has no windows (cyclic, anchored, sparse)."""
        fls = getattr(self, "_fls", None)
        if fls is None:
            from ..ops.longstring import FastLongScanner

            prog = self.prog
            fls = False
            if prog.F is not None and prog.horizon is not None:
                blk = max(16384, -(-8 * (prog.horizon + 2) // 128) * 128)
                cand = FastLongScanner(prog, block=blk)
                if cand.overlap is not None:
                    fls = cand
            self._fls = fls
        return fls or None

    def _alias_dist(self):
        """DistScanner over the X{m,} seeded alias of a whole-pattern
        X{m,n} blowup (engine.seeded_alias_program): seeded entry points
        (stats, grep, lazy spans, long modes) scan the handful-of-states
        alias on every chip instead of the >1024-state container program.
        Single-pattern scanners only (accept channels stay original)."""
        ad = getattr(self, "_adist", None)
        if ad is None:
            ad = False
            if self.P == 1 and not self._has_accept_map:
                from ..engine import seeded_alias_program

                ap = seeded_alias_program(self.prog)
                if ap is not None:
                    ad = DistScanner(
                        ap, self.mesh, self.axis,
                        backend=self.backend_requested,
                    )
            self._adist = ad
        return ad or None

    def long_stats(self, text_bytes, *, mode: str = "count"):
        """count/any over ONE long string, sharded: the overlapped windows
        (ops/longstring.py FastLongScanner / CountLongScanner) are
        independent, so they split over the data axis with a single psum
        of the per-shard counts — the sequence-parallelism axis of
        SURVEY.md §5. Windowed patterns only; the portable summary SPMD
        path otherwise."""
        assert mode in ("count", "any")
        n = (
            len(text_bytes)
            if isinstance(text_bytes, (bytes, bytearray))
            else int(text_bytes.shape[0])
        )
        if self.prog.nullable:
            return n + 1 if mode == "count" else True
        ad = self._alias_dist()
        if ad is not None:
            return ad.long_stats(text_bytes, mode=mode)

        def host_bytes():
            return (
                np.frombuffer(text_bytes, np.uint8)
                if isinstance(text_bytes, (bytes, bytearray))
                else np.asarray(text_bytes, np.uint8)
            )

        cls = self._long_count_scanner()
        fls = None if cls is not None else self._long_fast_scanner()
        if n == 0 or (cls is None and fls is None):
            if mode == "count":
                return self.long_count(text_bytes)
            flags = self.long_flags(text_bytes, seeded=True)
            return bool((flags[: n + 2] > 0).any())
        # windows sharded over the data axis, one psum. The stream itself
        # is sharded: each device holds its C-byte chunk, and the H-byte
        # window lookahead arrives by ppermute halo exchange inside the
        # SPMD program. 0x80 and 0xFF are dead bytes (ASCII alphabet).
        if cls is not None:
            blk, lead, _, _, _, _, C, H = self._cls_geom(n, cls)
            ext = np.full(self.mesh.devices.size * C + H, 128, np.uint8)
            ext[lead : lead + n] = host_bytes()
            X, R = self._shard_stream(ext, C, H)
            total = self._long_count_spmd(X, R, n=n, cls=cls)
        else:
            o = fls.overlap
            _, _, C, H = self._fls_geom(n, fls)
            ext = np.full(self.mesh.devices.size * C + H, 0xFF, np.uint8)
            ext[o : o + n] = host_bytes()
            X, R = self._shard_stream(ext, C, H)
            total = self._long_stats_spmd(X, R, n=n, fls=fls)
        return int(total) if mode == "count" else bool(int(total) > 0)

    # -- sharded-stream geometry + placement ------------------------------
    def _cls_geom(self, n: int, cls):
        """(blk, lead, nw, Lw, nseg, nw_dev, C, H) for the counting-window
        sharded stream: per-device chunk C bytes + halo H bytes."""
        from ..ops.longstring import count_window_geom

        blk, lead = cls.window_block(n), cls.lead
        D = self.mesh.devices.size
        nw, Lw, nseg = count_window_geom(n, blk, lead)
        nw_dev = -(-nw // D)
        return blk, lead, nw, Lw, nseg, nw_dev, blk * nw_dev, blk * nseg

    def _fls_geom(self, n: int, fls):
        """(blk, npw, C, H) for the overlapped-window sharded stream:
        npw windows of blk owned bytes per device (a packing-group
        multiple), chunk C = npw * blk bytes, halo H = the overlap."""
        D = self.mesh.devices.size
        G = max(1, self.prog.G)
        blk = fls._blk(-(-n // D) * D)
        nw = max(1, -(-n // blk))
        npw = -(-(-(-nw // D)) // G) * G
        return blk, npw, npw * blk, fls.overlap

    def _shard_stream(self, ext: np.ndarray, C: int, H: int):
        """Place a [D*C + H] host stream as a [D, C] chunk-sharded array
        plus a replicated [H] tail. Per-device memory = C + H bytes ≈
        n/D + overlap — asserted by ``__graft_entry__.dryrun_multichip``
        via ``last_stream_geom``."""
        D = self.mesh.devices.size
        assert ext.shape[0] == D * C + H, (ext.shape, D, C, H)
        X = jax.device_put(
            ext[: D * C].reshape(D, C),
            NamedSharding(self.mesh, P(self.axis, None)),
        )
        R = jax.device_put(ext[D * C :], NamedSharding(self.mesh, P()))
        self.last_stream_geom = (C, H, X.sharding.shard_shape(X.shape))
        return X, R

    @functools.partial(jax.jit, static_argnames=("self", "n", "cls"))
    def _long_count_spmd(self, X, R, *, n: int, cls):
        """Sharded counting windows: each device owns nw_dev windows of
        ``blk`` payload bytes (+ ``cls.lead`` re-scanned context), runs
        the run-length scan locally, and ONE psum reduces the match-end
        counts — the whole scan is a single SPMD program. The byte stream
        arrives chunk-sharded ([D, C] X + [H] tail R); each device
        ppermutes in its H-byte lookahead halo."""
        blk, lead, _, Lw, nseg, nw_dev, C, H = self._cls_geom(n, cls)
        D = self.mesh.devices.size
        axis = self.axis

        @functools.partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(self._spec_in, P()),
            out_specs=P(),
            check_vma=False,
        )
        def _go(Xl, tail):
            buf = _halo_buf(Xl[0], tail, C=C, H=H, D=D, axis=axis)
            win = jnp.concatenate(
                [
                    buf[i * blk : (i + nw_dev) * blk].reshape(nw_dev, blk)
                    for i in range(nseg)
                ],
                axis=1,
            )[:, :Lw]
            w0 = jax.lax.axis_index(axis).astype(jnp.int32) * nw_dev
            w = w0 + jnp.arange(nw_dev, dtype=jnp.int32)
            lens = lead + jnp.clip(n - w * blk, 0, blk)
            cnt, _, _, _, _ = cls.cs.match_stats_b(
                win, lens.reshape(-1, 1), seeded=True, lead=lead
            )
            return jax.lax.psum(jnp.sum(cnt), axis)

        return _go(X, R)

    @functools.partial(jax.jit, static_argnames=("self", "n", "fls"))
    def _long_stats_spmd(self, X, R, *, n: int, fls):
        """Sharded overlapped windows: device d owns windows
        [d*npw, (d+1)*npw) of the left-context layout (window w =
        ext[w*blk : w*blk + o + blk], ext = o dead bytes + the string),
        scans them through the batch route with ``lead = o`` and psums
        the counts."""
        o = fls.overlap
        blk, npw, C, H = self._fls_geom(n, fls)
        D = self.mesh.devices.size
        axis = self.axis

        @functools.partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(self._spec_in, P()),
            out_specs=P(),
            check_vma=False,
        )
        def _go(Xl, halo_tail):
            seg = _halo_buf(Xl[0], halo_tail, C=C, H=H, D=D, axis=axis)
            ctx = seg[:C].reshape(npw, blk)[:, :o]
            main = seg[o : o + C].reshape(npw, blk)
            win = jnp.concatenate([ctx, main], axis=1)
            w0 = jax.lax.axis_index(axis).astype(jnp.int32) * npw
            w = w0 + jnp.arange(npw, dtype=jnp.int32)
            lens = jnp.clip(n - w * blk + o, 0, o + blk)
            cnt, _, _ = fls.engine.window_stats(win, lens, lead=o)
            return jax.lax.psum(jnp.sum(cnt), axis)

        return _go(X, R)
