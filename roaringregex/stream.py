"""Out-of-core corpus streaming: chunked host→device pipelined scan.

BASELINE config 5 specifies a 10 GB corpus, and a corpus need not fit in
device memory at all. The reference streams stdin one line at a time
(src/test/main.cpp:17-20); here the equivalent is a **pipelined chunk
stream**: fixed-shape record batches are device_put asynchronously with
up to ``depth`` chunks in flight while earlier chunks' scans drain on
device, so wall time approaches ``max(upload_time, scan_time)`` instead
of their sum. Scan results are tiny device scalars (or per-record
bitmaps) fetched as chunks retire — the corpus itself never round-trips.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from .engine import ScanEngine


@dataclass
class StreamStats:
    """Aggregate of one streamed scan."""

    matches: int  # total distinct match-end positions (all patterns)
    matched_records: int  # records with >= 1 match (any pattern)
    records: int  # real records scanned: the chunk's n_real when the
    # batch iterator yields (data, lengths, n_real) triples (e.g.
    # iter_line_batches), else every row of the given chunk
    bytes: int  # corpus bytes scanned
    chunks: int  # device dispatches


class StreamScanner:
    """Compile-once / stream-many scanner with a depth-K upload pipeline.

    ``batches`` iterables yield ``(data [B, L] uint8, lengths [B] int32)``
    pairs or ``(data, lengths, n_real)`` triples. Chunks are padded to
    the engine's packing group internally; rows beyond ``n_real`` are
    treated as phantom padding (excluded from nullable-pattern match
    accounting). Do NOT pre-pad chunks yourself without passing
    ``n_real`` — the pad rows would count as real records. Each new
    (B, L) shape compiles once, so keep shapes repeating.
    """

    def __init__(
        self,
        pattern_or_engine: Union[str, ScanEngine],
        *,
        depth: int = 3,
        backend: Optional[str] = None,
    ):
        """Accepts a pattern string, a ScanEngine, or a MultiPattern (its
        combined-automaton engine scans P patterns per chunk in ONE pass;
        per-record hits are the union over pattern channels)."""
        from .api import MultiPattern

        self.P = 1
        self._null_mask = None
        # _engine_nullable: the engine's kernels apply the nullable
        # correction themselves (plain Pattern engines). MultiPattern
        # engines always run nullable=False and leave per-channel
        # correction to us, whatever P is.
        self._engine_nullable = False
        if isinstance(pattern_or_engine, MultiPattern):
            mp = pattern_or_engine
            if mp._singles is not None:
                raise ValueError(
                    "multi-pattern streaming needs the combined-automaton "
                    "engine (packed/pallas backend); this MultiPattern "
                    "fell back to per-pattern scans"
                )
            self.engine = mp.engine
            self.P = mp.P
            self._nullables = np.asarray(mp.nullables, bool)
        elif isinstance(pattern_or_engine, ScanEngine):
            self.engine = pattern_or_engine
            self.P = self.engine.P
            if self.P > 1 and self.engine.prog.nullable:
                raise ValueError(
                    "pass the MultiPattern itself (not its engine) for "
                    "multi-channel streaming with nullable patterns — "
                    "per-channel nullability is not recoverable from the "
                    "combined engine"
                )
            self._nullables = np.zeros(max(self.P, 1), bool)
            self._engine_nullable = bool(self.engine._nullable)
            self._nullables[:] = self._engine_nullable and self.P == 1
        else:
            from .compiler.serialize import cached_compile

            self.engine = ScanEngine(
                cached_compile(str(pattern_or_engine)), backend=backend
            )
            self._engine_nullable = bool(self.engine._nullable)
            self._nullables = np.asarray([self._engine_nullable])
        if self._nullables.any() and not self._engine_nullable:
            import jax.numpy as jnp

            # engine emits raw counts/hits for nullable channels; an
            # empty match hits every record, so OR those channels in
            self._null_mask = jnp.asarray(self._nullables)[None, :]
        self.depth = max(1, int(depth))
        self._jits = {}

    def _pad_group(self, data, lengths):
        """Round the chunk's record count up to the engine's packing
        group with zero-length phantom records (the packed engine scans G
        records per row). Returns (data, lengths, B_real_rows)."""
        G = max(1, self.engine.prog.G)
        B = data.shape[0]
        Bp = -(-B // G) * G
        if Bp != B:
            data = np.concatenate(
                [np.asarray(data),
                 np.zeros((Bp - B, data.shape[1]), np.uint8)]
            )
            lengths = np.concatenate(
                [np.asarray(lengths, np.int32), np.zeros(Bp - B, np.int32)]
            )
        return data, lengths, B

    # -- jit caches --------------------------------------------------------
    def _stats_fn(self):
        import jax
        import jax.numpy as jnp

        fn = self._jits.get("stats")
        if fn is None:
            eng = self.engine

            P = max(1, self.P)

            def run(d, l):
                cnt, _, anym = eng.match_stats(d, l, seeded=True)
                anym = self._union_channels(anym)
                # int32 on device (a chunk's totals fit easily); the
                # cross-chunk accumulation is int64 host-side
                cnt_pc = jnp.sum(
                    cnt.reshape(-1, P), axis=0, dtype=jnp.int32
                )  # [P] per-channel totals
                return jnp.concatenate([
                    cnt_pc,
                    jnp.sum(anym.astype(jnp.int32))[None],
                    jnp.sum(l.astype(jnp.int32))[None],
                ])  # [P + 2]

            fn = self._jits["stats"] = jax.jit(run)
        return fn

    def _union_channels(self, anym):
        """[B*P] per-channel hits -> [B] per-record union (multi-pattern
        grep semantics: a line matches if ANY pattern matches). Applies
        the nullable-channel OR even for P == 1 (a single-pattern
        MultiPattern engine emits raw hits for a nullable pattern)."""
        if self.P <= 1 and self._null_mask is None:
            return anym
        per = anym.reshape(-1, max(self.P, 1))
        if self._null_mask is not None:
            per = per | self._null_mask
        return per.any(axis=1)

    def _hits_fn(self):
        import jax

        fn = self._jits.get("hits")
        if fn is None:
            eng = self.engine

            def run(d, l):
                _, _, anym = eng.match_stats(d, l, seeded=True)
                return self._union_channels(anym)

            fn = self._jits["hits"] = jax.jit(run)
        return fn

    # -- streaming entry points -------------------------------------------
    def _drive(self, batches, fn, payload=None):
        """Run the whole stream FETCH-FREE and return [(device_out, meta)].

        Backpressure is ``block_until_ready`` on the depth-old chunk — a
        pure sync with no device→host transfer; result scalars stay on
        device until the final chunk and are then gathered in one
        transfer (a few bytes per chunk), so no chunk pays a round trip."""
        import jax
        import jax.numpy as jnp

        outs = []
        live = collections.deque()
        for batch in batches:
            data, lengths, n_real = self._norm_batch(batch)
            d = jax.device_put(jnp.asarray(data))
            l = jax.device_put(jnp.asarray(np.asarray(lengths, np.int32)))
            out = fn(d, l)
            meta = payload(data, lengths, n_real) if payload else None
            outs.append((out, meta))
            live.append(out)
            if len(live) >= self.depth:
                jax.block_until_ready(live.popleft())
        if live:
            jax.block_until_ready(list(live))
        return outs

    def _norm_batch(self, batch):
        """(data, lengths[, n_real]) -> G-padded (data, lengths, n_real).
        n_real defaults to the full record count of the given chunk
        (callers that pad their own phantom rows, like iter_line_batches,
        pass the real count explicitly for exact nullable accounting)."""
        if len(batch) == 3:
            data, lengths, n_real = batch
        else:
            data, lengths = batch
            n_real = int(np.asarray(data).shape[0])
        data, lengths, _ = self._pad_group(data, lengths)
        return data, lengths, int(n_real)

    def stats_stream(self, batches) -> StreamStats:
        """Global (matches, matched_records, records, bytes) over a chunk
        stream — the grep -c aggregate. One jitted dispatch per chunk;
        P + 2 device scalars per chunk (per-channel counts + matched +
        bytes), gathered after the stream in ONE stacked transfer.
        Nullable patterns /
        channels are corrected host-side: phantom pad rows are excluded
        and empty-match counts (len + 1 per real record) are exact when
        the batch iterator provides n_real."""
        import jax.numpy as jnp

        fn = self._stats_fn()
        outs = self._drive(
            batches, fn,
            payload=lambda d, l, nr: (nr, int(d.shape[0])),
        )
        if not outs:
            return StreamStats(0, 0, 0, 0, 0)
        P = max(1, self.P)
        packed = np.asarray(
            jnp.stack([o for o, _ in outs])
        )  # [chunks, P + 2], one D2H
        sums = packed.sum(axis=0, dtype=np.int64)
        cnt_pc, nrec, nbytes = sums[:P], int(sums[P]), int(sums[P + 1])
        n_real = sum(nr for (nr, _) in (m for _, m in outs))
        n_pad = sum(bp - nr for _, (nr, bp) in outs)
        # nullable corrections (phantom pad rows + empty-match counts the
        # combined multi-pattern engine doesn't emit):
        if self._engine_nullable:
            # engine kernels already count empty matches — but they also
            # count each phantom pad row as 1 match + 1 matched record
            cnt_pc = cnt_pc - n_pad
            nrec -= n_pad
        elif self._nullables.any():
            # nullable channels: exact count over real records is
            # sum(len + 1) = bytes + n_real (the engine runs
            # nullable=False and emits raw automaton counts there); the
            # union hit every padded row — real records all match
            cnt_pc = cnt_pc.copy()
            cnt_pc[self._nullables] = nbytes + n_real
            nrec = n_real
        total = int(cnt_pc.sum())
        return StreamStats(total, nrec, n_real, nbytes, len(outs))

    def spans_stream(
        self, batches, *, cap: int = 32, longest: bool = False
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Yield per-chunk ``(starts [B, cap], ends [B, cap], count [B],
        overflow [B], lengths [B])`` — span extraction out-of-core (the
        CLI ``--stream -o`` path; the reference's only match output is a
        span, regex.h:100-105).

        Spans are enumerated on device per chunk into fixed ``cap``-slot
        buffers (engine.spans); ``count`` is the exact total per record,
        so ``overflow[i] = count[i] > cap`` tells the caller which records
        were truncated (the yielded ``data`` row re-runs them exactly).
        Single-pattern engines on a device-span route only; nullable
        patterns raise (their lazy span set is the closed-form empty match
        at every position).
        Yields ``(starts, ends, count, overflow, data, lengths)``."""
        import jax
        import jax.numpy as jnp

        eng = self.engine
        if self.P != 1:
            raise ValueError("spans_stream is single-pattern")
        if self._nullables.any():
            raise ValueError(
                "spans_stream on a nullable pattern: the span set is the "
                "closed-form empty match at every position"
            )
        if not eng.device_spans:
            raise ValueError(
                "spans_stream needs device span enumeration (the pallas "
                "backend)"
            )

        def run(d, l):
            return eng.spans(d, l, cap=cap, longest=longest)

        fn = self._jits.get(("spans", cap, longest))
        if fn is None:
            fn = self._jits[("spans", cap, longest)] = jax.jit(run)
        inflight = collections.deque()

        def emit(item):
            (s, e, c, over), dd, ln = item
            s, e, c = np.asarray(s), np.asarray(e), np.asarray(c)
            return s, e, c, np.asarray(over), dd, ln

        for batch in batches:
            data, lengths, _ = self._norm_batch(batch)
            d = jax.device_put(jnp.asarray(data))
            l = jax.device_put(jnp.asarray(np.asarray(lengths, np.int32)))
            inflight.append((fn(d, l), data, np.asarray(lengths)))
            if len(inflight) >= self.depth:
                yield emit(inflight.popleft())
        while inflight:
            yield emit(inflight.popleft())

    def hits_stream(
        self, batches, *, defer: bool = False
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield per-chunk ``(hits [B] bool, data [B, L], lengths [B])``
        in order — the grep line-printing path.

        ``defer=False`` (default) fetches each chunk's [B] hit bitmap as
        it retires: O(depth) host memory, true streaming output.
        ``defer=True`` keeps every chunk's bitmap on device and all host
        data alive until the stream ends: no fetch inside the stream,
        O(corpus) host memory — the right mode when the corpus fits in
        RAM but not in device memory."""
        import jax
        import jax.numpy as jnp

        fn = self._hits_fn()
        payload = lambda d, l, nr: (d, np.asarray(l))  # noqa: E731
        if defer:
            for hits, (data, lengths) in self._drive(batches, fn, payload):
                yield np.asarray(hits), data, lengths
            return
        inflight = collections.deque()
        for batch in batches:
            data, lengths, _ = self._norm_batch(batch)
            d = jax.device_put(jnp.asarray(data))
            l = jax.device_put(jnp.asarray(np.asarray(lengths, np.int32)))
            inflight.append((fn(d, l), (data, np.asarray(lengths))))
            if len(inflight) >= self.depth:
                hits, (dd, ll) = inflight.popleft()
                yield np.asarray(hits), dd, ll
        while inflight:
            hits, (dd, ll) = inflight.popleft()
            yield np.asarray(hits), dd, ll


def pack_records(lines, B: int, L: int):
    """[B, L] batch from <= B byte records (phantom zero-length pad)."""
    data = np.zeros((B, L), np.uint8)
    lengths = np.zeros(B, np.int32)
    for i, b in enumerate(lines):
        n = min(len(b), L)
        data[i, :n] = np.frombuffer(b[:n], np.uint8)
        lengths[i] = n
    return data, lengths


def iter_line_batches(
    fileobj,
    *,
    rows: int = 65536,
    chunk_bytes: int = 32 << 20,
    min_len: int = 256,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Newline-delimited records from a binary stream as fixed-shape
    batches ``(data [rows, L], lengths, n_real)``.

    Reads ``chunk_bytes`` at a time, carrying the partial trailing line
    into the next chunk. L is a power of two that only grows (a longer
    line widens every later batch), so the jit cache sees few shapes.
    Lines longer than 2^20 bytes are truncated (loudly)."""
    import sys

    L = min_len
    carry = b""
    eof = False
    pending: collections.deque = collections.deque()
    while True:
        while not eof and len(pending) < rows:
            buf = fileobj.read(chunk_bytes)
            if not buf:
                eof = True
                if carry:
                    pending.append(carry)
                    carry = b""
                break
            buf = carry + buf
            lines = buf.split(b"\n")
            carry = lines.pop()
            pending.extend(lines)
        if not pending:
            break
        longest = max((len(b) for b in pending), default=1)
        if longest > (1 << 20):
            print(
                "rrx stream: truncating lines longer than 1 MiB",
                file=sys.stderr,
            )
            longest = 1 << 20
        while L < longest:
            L *= 2
        take = []
        while pending and len(take) < rows:
            take.append(pending.popleft())
        data, lengths = pack_records(take, rows, L)
        yield data, lengths, len(take)


def stream_file_stats(
    pattern: str,
    fileobj,
    *,
    depth: int = 3,
    rows: int = 65536,
    chunk_bytes: int = 32 << 20,
    backend: Optional[str] = None,
) -> StreamStats:
    """grep -c over an arbitrarily large newline-delimited stream."""
    sc = StreamScanner(pattern, depth=depth, backend=backend)
    return sc.stats_stream(
        iter_line_batches(fileobj, rows=rows, chunk_bytes=chunk_bytes)
    )
