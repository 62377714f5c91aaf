"""Long-string scan parallelism: one huge string split across blocks.

The per-byte NFA step is the composition of boolean affine maps

    v  ->  (follow(v) & B[c])  |  seed_t

and composition of such maps is **associative**, so one string's scan
factors into (1) per-block *summaries* computed in parallel, (2) an
associative prefix combine over blocks, (3) per-block replay from the now
known entry states — again in parallel. This is the framework's sequence-
parallelism story (SURVEY.md §5 "long-context" row, §7.2 step 8): the
reference can only scan one byte at a time on one core (regex.h:157).

A block summary is the affine pair (M, s):

* ``M [S, S]``: M[i, j] = 1 iff starting the block in state i ends it in a
  state set containing j (computed by scanning the identity batch);
* ``s [S]``: states live at block end due to seeds injected *inside* the
  block (every step in seeded/search mode; the two BOS-side seeds of the
  anchored convention in the global first block only).

Combine (associative):  (Ma, sa) ∘ (Mb, sb) = (Ma·Mb, sa·Mb | sb)
with · the boolean matmul (0/1 operands), run under lax.associative_scan.
Entry state of block k is then spref[k-1] (all seeding flows through s).

Cost: pass 1 scans S+1 pseudo-records per block, so the parallel scheme
wins once the block count exceeds ~S. The same primitives run sharded:
blocks split over the data mesh axis (DistScanner.long_flags), with only
the tiny [nb, S, S] summary tensor crossing devices.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler.program import DeviceProgram
from . import scan_xla as sx

DTYPE = jnp.bfloat16


def _step_fn(tables):
    M = tables["M"]
    c_pad = tables["Bc"].shape[0]
    K = tables["K"]

    def step(v, cls_col):
        oh = (cls_col[:, None] == jnp.arange(c_pad)[None, :]).astype(DTYPE)
        u = jnp.concatenate([v, oh], axis=1)
        acc = jnp.dot(u, M, preferred_element_type=jnp.float32)
        return (acc > K).astype(DTYPE)

    return step


@functools.partial(jax.jit, static_argnames=("s_pad", "seeded"))
def block_summaries(
    tables: Dict[str, jnp.ndarray],
    cls_b: jnp.ndarray,  # [nb, block] int32 class columns per block
    first_gate: jnp.ndarray,  # [nb] 1.0 where the block is the global first
    *,
    s_pad: int,
    seeded: bool,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-block affine summaries (M [nb,S,S], s [nb,S])."""
    nb, block = cls_b.shape
    step = _step_fn(tables)
    seed_vec = jnp.zeros((s_pad,), DTYPE).at[0].set(1)
    eye = jnp.concatenate(
        [jnp.eye(s_pad, dtype=DTYPE), jnp.zeros((1, s_pad), DTYPE)], axis=0
    )
    v0 = jnp.tile(eye, (nb, 1))  # [nb*(S+1), S]
    acc_row = jnp.tile(
        jnp.concatenate([jnp.zeros(s_pad), jnp.ones(1)]).astype(DTYPE), (nb,)
    )[:, None]
    first_rows = acc_row * jnp.repeat(
        first_gate.astype(DTYPE), s_pad + 1
    )[:, None]

    def body(v, xs):
        cls_t, t = xs
        if seeded:
            gate = acc_row
        else:
            gate = first_rows * (t < 2)  # BOS-side seeds, global block 0 only
        v = jnp.maximum(v, gate * seed_vec[None, :])
        return step(v, jnp.repeat(cls_t, s_pad + 1)), None

    vT, _ = jax.lax.scan(body, v0, (cls_b.T, jnp.arange(block)))
    summ = vT.reshape(nb, s_pad + 1, s_pad)
    return summ[:, :s_pad, :], summ[:, s_pad, :]


@functools.partial(jax.jit, static_argnames=("seeded",))
def block_replay(
    tables: Dict[str, jnp.ndarray],
    cls_b: jnp.ndarray,  # [nb, block]
    ventry: jnp.ndarray,  # [nb, S] entry state per block
    first_gate: jnp.ndarray,  # [nb]
    *,
    seeded: bool,
) -> jnp.ndarray:
    """Replay blocks from known entry states; accept flags [nb, block]."""
    nb, block = cls_b.shape
    s_pad = ventry.shape[1]
    step = _step_fn(tables)
    seed_vec = jnp.zeros((s_pad,), DTYPE).at[0].set(1)
    fg = first_gate.astype(DTYPE)[:, None]

    def body(v, xs):
        cls_t, t = xs
        if seeded:
            gate = jnp.asarray(1, DTYPE)
        else:
            gate = fg * (t < 2)
        v = jnp.maximum(v, gate * seed_vec[None, :])
        v2 = step(v, cls_t)
        flag = (
            jnp.dot(v2, tables["accept"], preferred_element_type=jnp.float32)
            > 0
        )
        return v2, flag

    _, flags = jax.lax.scan(
        body, ventry.astype(DTYPE), (cls_b.T, jnp.arange(block))
    )
    return flags.T  # [nb, block]


@jax.jit
def prefix_entries(Ms: jnp.ndarray, ss: jnp.ndarray) -> jnp.ndarray:
    """Associative prefix of affine summaries -> entry state per block."""
    def combine(a, b):
        Ma, sa = a
        Mb, sb = b
        Mab = (
            jnp.einsum("nij,njk->nik", Ma, Mb,
                       preferred_element_type=jnp.float32) > 0
        ).astype(DTYPE)
        sab = jnp.maximum(
            (
                jnp.einsum("nj,njk->nk", sa, Mb,
                           preferred_element_type=jnp.float32) > 0
            ).astype(DTYPE),
            sb,
        )
        return Mab, sab

    _, spref = jax.lax.associative_scan(combine, (Ms, ss), axis=0)
    s_pad = ss.shape[1]
    return jnp.concatenate(
        [jnp.zeros((1, s_pad), DTYPE), spref[:-1].astype(DTYPE)], axis=0
    )


@functools.partial(
    jax.jit,
    static_argnames=("length", "block", "seeded", "bos_class", "eos_class"),
)
def scan_long(
    tables: Dict[str, jnp.ndarray],
    data: jnp.ndarray,  # [L] uint8
    *,
    length: int,
    block: int = 1024,
    seeded: bool = True,
    bos_class: int = 0,
    eos_class: int = 0,
) -> jnp.ndarray:
    """Block-parallel scan of ONE string; flags [T = L+2] per stream step."""
    s_pad = tables["accept"].shape[0]
    cls = sx.encode_stream(
        tables, data[None, :], jnp.asarray([length]), bos_class, eos_class, 0
    )[0]
    T = cls.shape[0]
    nb = -(-T // block)
    cls_b = jnp.pad(cls, (0, nb * block - T)).reshape(nb, block)
    first_gate = (jnp.arange(nb) == 0).astype(jnp.float32)
    Ms, ss = block_summaries(
        tables, cls_b, first_gate, s_pad=s_pad, seeded=seeded
    )
    ventry = prefix_entries(Ms, ss)
    flags = block_replay(tables, cls_b, ventry, first_gate, seeded=seeded)
    return flags.reshape(nb * block)[:T]


def compact_tables(prog: DeviceProgram) -> Dict[str, jnp.ndarray]:
    """Unpacked tables trimmed to the record tile (s_tile lanes instead of
    the 128/256-lane padded layout): the long-string passes scan an
    identity batch of S+1 pseudo-records per block, so padding a 7-state
    automaton to 128 lanes would cost 16x the rows AND 16x the lane width
    (~250x the FLOPs). Dense tiers only."""
    assert prog.F is not None, "compact tables need dense F"
    st = prog.s_tile
    F = prog.F[:st, :st]
    Bc = prog.Bc[:, :st]
    fuse_k = 1 << (st + 1).bit_length()
    M = np.concatenate([F, fuse_k * Bc.astype(np.int32)], axis=0)
    return {
        "K": jnp.asarray(fuse_k, jnp.float32),
        "M": jnp.asarray(M, DTYPE),
        "F": jnp.asarray(F, DTYPE),
        "Ft": jnp.asarray(F.T, DTYPE),
        "Bc": jnp.asarray(Bc, DTYPE),
        "accept": jnp.asarray(prog.accept[:st], DTYPE),
        "byte_class": jnp.asarray(prog.byte_class, jnp.int32),
    }


class LongScanner:
    """One-long-string scanner bound to a compiled program."""

    def __init__(self, prog: DeviceProgram, block: int = 1024):
        self.prog = prog
        self.block = block
        self.tables = (
            compact_tables(prog)
            if prog.F is not None
            else sx.device_tables(prog)
        )

    def _flags(self, text: bytes, seeded: bool) -> np.ndarray:
        data = jnp.asarray(np.frombuffer(text, dtype=np.uint8))
        return np.asarray(
            scan_long(
                self.tables,
                data,
                length=len(text),
                block=self.block,
                seeded=seeded,
                bos_class=self.prog.bos_class,
                eos_class=self.prog.eos_class,
            )
        )

    def ends_bitmap(self, text: bytes) -> np.ndarray:
        """[len+1] bool: some match (any start) ends at position e — the
        long-string analog of OracleEngine.ends."""
        n = len(text)
        flags = self._flags(text, seeded=True)
        e = np.clip(np.arange(n + 2), 0, n)
        out = np.zeros(n + 1, bool)
        np.maximum.at(out, e, flags[: n + 2] > 0)
        if self.prog.nullable:
            out[:] = True
        return out

    def count_ends(self, text: bytes) -> int:
        return int(self.ends_bitmap(text).sum())

    def search(self, text: bytes) -> bool:
        return bool(self.ends_bitmap(text).any())

    def fullmatch(self, text: bytes) -> bool:
        n = len(text)
        if n == 0:
            return self.prog.nullable
        flags = self._flags(text, seeded=False)
        e = np.clip(np.arange(n + 2), 0, n)
        covers = np.arange(n + 2) >= n
        return bool(((flags[: n + 2] > 0) & (e == n) & covers).any())


# ---------------------------------------------------------------------------
# Overlapped windows: bounded-horizon patterns through the batch route
# ---------------------------------------------------------------------------


def _as_device(text):
    """(device uint8 array, length) for bytes or an array."""
    if isinstance(text, (bytes, bytearray)):
        return jnp.asarray(np.frombuffer(text, np.uint8)), len(text)
    return jnp.asarray(text), int(text.shape[0])


class FastLongScanner:
    """Long-string scan by horizon-bounded overlapped windows.

    A pattern whose follow graph is acyclic has a finite influence
    horizon (DeviceProgram.horizon): the seeded state at any position
    depends only on the last ``horizon`` bytes. So the string splits into
    windows of ``blk`` owned bytes, each re-scanning ``overlap`` context
    bytes owned by the previous window, and every window is then exact.
    The windows form ONE record batch, scanned by the path
    ``platform.route`` picks for batches (the word kernel or the packed
    engine): seeded count/any/first as one match-statistics pass with
    ``lead = overlap``, the ends and starts bitmaps as one flag pass each.

    Window edges are not string edges, so anchored patterns (BOS/EOS
    symbols live) have no windows; they, cyclic patterns and unseeded
    (fullmatch) scans take the portable summary+replay scanner
    (LongScanner). Stream offsets are int32: single strings up to ~2 GB
    (shard longer corpora, parallel/dist.py).
    """

    def __init__(self, prog: DeviceProgram, block: int = 16384):
        from ..engine import ScanEngine

        assert prog.F is not None, "unsupported tier"
        assert block % 128 == 0, "block must be a multiple of 128"
        self.prog = prog
        self.block = block
        h = prog.horizon
        self.overlap = (
            h + 2
            if (h is not None and h + 2 <= block // 8 and not prog.uses_anchor)
            else None
        )
        self.engine = ScanEngine(prog)
        self._summary = None

    @property
    def summary(self) -> "LongScanner":
        """The portable summary+replay scanner (built on first use)."""
        if self._summary is None:
            self._summary = LongScanner(self.prog, block=min(self.block, 4096))
        return self._summary

    # -- window geometry ----------------------------------------------------
    def _blk(self, n: int) -> int:
        """Owned bytes per window: enough windows (~64k) to fill the
        device's record lanes, at least 8x the overlap (re-scan tax under
        1/8), at most ``block``."""
        blk = -(-max(n, 1) // 65536)
        blk = max(256, 8 * self.overlap, -(-blk // 128) * 128)
        return min(-(-blk // 128) * 128, self.block)

    def _windows(self, data, n: int, right: bool):
        """([nw_pad, blk + o] windows, [nw_pad] lengths, nw, blk).
        ``right=False``: window w = text[w*blk - o : (w+1)*blk] (left
        context, dead 0xFF before the string start); ``right=True``:
        window w = text[w*blk : (w+1)*blk + o] (right context, for start
        hits). Windows are padded to the packing group with empty ones."""
        o = self.overlap
        blk = self._blk(n)
        nw = max(1, -(-n // blk))
        G = max(1, self.prog.G)
        nwp = -(-nw // G) * G
        w = jnp.arange(nwp, dtype=jnp.int32) * blk
        ds = jnp.full((nwp + 1) * blk + o, 0xFF, jnp.uint8)
        if right:
            ds = jax.lax.dynamic_update_slice(ds, data, (0,))
            main = ds[: nwp * blk].reshape(nwp, blk)
            ctx = ds[blk : (nwp + 1) * blk].reshape(nwp, blk)[:, :o]
            win = jnp.concatenate([main, ctx], axis=1)
            lens = jnp.clip(n - w, 0, blk + o)
        else:
            ds = jax.lax.dynamic_update_slice(ds, data, (o,))
            ctx = ds[: nwp * blk].reshape(nwp, blk)[:, :o]
            main = ds[o : o + nwp * blk].reshape(nwp, blk)
            win = jnp.concatenate([ctx, main], axis=1)
            lens = jnp.clip(n - w + o, 0, blk + o)
        return win, lens.astype(jnp.int32), nw, blk

    # -- window passes (jitted; n static) -----------------------------------
    @functools.partial(jax.jit, static_argnames=("self", "n"))
    def _window_stats(self, data, *, n: int):
        """(count, any, global first end) over the whole string."""
        o = self.overlap
        win, lens, nw, blk = self._windows(data, n, right=False)
        cnt, first, _ = self.engine.window_stats(win, lens, lead=o)
        off = jnp.arange(cnt.shape[0], dtype=jnp.int32) * blk - o
        big = jnp.int32(1 << 30)
        fg = jnp.min(jnp.where(first >= 0, first + off, big))
        total = jnp.sum(cnt)
        return total, total > 0, jnp.where(fg >= big, -1, fg)

    @functools.partial(jax.jit, static_argnames=("self", "n"))
    def _window_flags(self, data, *, n: int):
        """[n + 2] seeded accept flags per global stream step."""
        o = self.overlap
        win, lens, nw, blk = self._windows(data, n, right=False)
        fl = self.engine.forward_flags(win, lens, seeded=True)
        # window-local end e = o + 1 + k (column e + 1) is global end
        # w*blk + 1 + k
        ends = fl[:nw, o + 2 : o + 2 + blk].reshape(-1)[:n]
        z = jnp.zeros(1, bool)
        return jnp.concatenate([z, ends, z])

    @functools.partial(jax.jit, static_argnames=("self", "n"))
    def _window_starts(self, data, *, n: int):
        """[n + 1] start bitmap (bit s: some match starts at s)."""
        win, lens, nw, blk = self._windows(data, n, right=True)
        h = self.engine.reverse_hits(win, lens)  # column j: start j - 1
        st = h[:nw, 1 : 1 + blk]
        st = st.at[:, 0].set(st[:, 0] | h[:nw, 0])
        return jnp.concatenate(
            [st.reshape(-1)[:n], jnp.zeros(1, bool)]
        )

    # -- dispatch ----------------------------------------------------------
    @staticmethod
    def _tail(flags, n: int, mode: str):
        if mode == "flags":
            return flags
        if mode == "count":
            body = jnp.sum((flags[:n] > 0).astype(jnp.int32))
            tail = ((flags[n] > 0) | (flags[n + 1] > 0)).astype(jnp.int32)
            return body + tail
        if mode == "any":
            return jnp.any(flags[: n + 2] > 0)
        return (flags[n] > 0) | (flags[n + 1] > 0)  # fullmatch

    def _run(self, text, seeded: bool, mode: str):
        """Un-synced device value for ``mode`` in (flags, count, any,
        full): flags [n + 2] per global stream step, or a scalar."""
        data, n = _as_device(text)
        if seeded and self.overlap is not None and n > 0:
            if mode == "flags":
                return self._window_flags(data, n=n)
            if mode in ("count", "any"):
                total, anyf, _ = self._window_stats(data, n=n)
                return total if mode == "count" else anyf
        sc = self.summary
        flags = scan_long(
            sc.tables, data, length=n, block=sc.block, seeded=seeded,
            bos_class=self.prog.bos_class, eos_class=self.prog.eos_class,
        )
        return self._tail(flags, n, mode)

    # -- public API ---------------------------------------------------------
    def flags(self, text, *, seeded: bool = True):
        """[T = len+2] accept flags per global stream step (device).
        ``text`` may be bytes or a device-resident uint8 array (preferred
        for repeated scans: host->device transfer dominates otherwise)."""
        return self._run(text, seeded, "flags")

    def starts_bitmap(self, text) -> np.ndarray:
        """[len+1] bool: some match starts at position s. Windowed
        patterns only (the reverse pass needs a finite suffix horizon);
        others raise ValueError — count/search/fullmatch still work there
        via summary mode."""
        if self.overlap is None:
            raise ValueError(
                "long-string start/span extraction needs a bounded-horizon "
                f"anchor-free pattern; {self.prog.pattern!r} is not"
            )
        data, n = _as_device(text)
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        if n == 0:
            return np.zeros(1, bool)
        return np.asarray(self._window_starts(data, n=n))

    def ends_bitmap(self, text) -> np.ndarray:
        """[len+1] bool, pulled to host (O(n) transfer; prefer the scalar
        entry points for repeated large-scale scans)."""
        data, n = _as_device(text)
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        flags = np.asarray(self.flags(data, seeded=True))
        e = np.clip(np.arange(n + 2), 0, n)
        out = np.zeros(n + 1, bool)
        np.maximum.at(out, e, flags[: n + 2] > 0)
        return out

    def count_ends(self, text) -> int:
        data, n = _as_device(text)
        if self.prog.nullable:
            return n + 1
        return int(self._run(data, True, "count"))

    def search(self, text) -> bool:
        if self.prog.nullable:
            return True
        return bool(self._run(text, True, "any"))

    def fullmatch(self, text) -> bool:
        data, n = _as_device(text)
        if n == 0:
            return self.prog.nullable
        return bool(self._run(data, False, "full"))


def count_window_geom(n: int, blk: int, lead: int):
    """(nw, Lw, nseg) for overlapped run-length windows: nw windows of
    ``blk`` payload bytes each re-scanning ``lead`` context bytes, built
    from nseg shifted block-reshapes of a dead-filled ext buffer. Shared
    by CountLongScanner._win and DistScanner._long_count_spmd so the two
    layouts cannot drift."""
    nw = max(1, -(-n // blk))
    Lw = lead + blk
    nseg = -(-Lw // blk) + 1
    return nw, Lw, nseg


class CountLongScanner:
    """One-long-string scan for counting-plan patterns (fixed-length-body
    ``X{m,n}``: ``a{1,300}``, ``(ab){2,600}``, ...).

    The seeded accept test at stream position t depends only on the last
    ``m*k`` bytes (m body copies of length k), so the string splits into
    ``block``-byte windows that each re-scan ``lead = m*k`` context bytes
    owned by the previous window and are then EXACT — one batched pass
    through the run-length scanner (CountScanner). No summaries, no
    matrix tiers, no S-dependence: this covers the
    family the reference's broken Roaring tier targets (Parser.cpp:165-168)
    on inputs of one huge string, including unbounded ``X{m,}`` whose
    cyclic follow graph rules out the FastLongScanner overlapped mode.

    Fullmatch has a closed form (length j*k with m <= j <= n and every
    byte in its phase class) — no scan at all."""

    def __init__(self, prog: DeviceProgram, plan, block: int = 32768):
        from .scan_count import CountScanner

        self.prog = prog
        self.m, self.n, self.body = plan  # body = R branch bodies
        self.k = len(self.body[0])
        mm = max(self.m, 1)
        self.lead = mm * self.k
        self.block = max(block, self._min_blk())
        # duck-types FastLongScanner for Pattern.finditer_long candidate
        # starts (bounded-horizon patterns only; checked there via horizon)
        self.overlap = self.lead
        self.cs = CountScanner(prog, plan)

    # -- window layout ------------------------------------------------------
    def _min_blk(self) -> int:
        return -(-4 * self.lead // 128) * 128

    def window_block(self, n: int, n_windows: int = 65536) -> int:
        """Payload bytes per window for an n-byte string: about
        ``n_windows`` windows (records in flight on the device), at least
        4x the lead (re-scan tax under 1/4), at most ``block``."""
        blk = -(-max(n, 1) // n_windows)
        blk = -(-blk // 128) * 128
        return min(max(blk, self._min_blk()), self.block)

    def _win(self, data, n: int, right: bool):
        """[nw, Lw] overlapped windows + [nw] lens. ``right=False``: window
        w = ext[w*blk : w*blk + lead + blk] with ``lead`` left-context bytes
        (0x80 dead filler before the stream start). ``right=True``: window
        w = data[w*blk : w*blk + blk + lead] (right context, reverse pass).
        Built from shifted reshapes — no device gathers."""
        blk, lead = self.window_block(n), self.lead
        nw, Lw, nseg = count_window_geom(n, blk, lead)
        ext_len = (nw + nseg) * blk
        ext = jnp.full(ext_len, 128, jnp.uint8)  # 0x80 = dead symbol
        off = 0 if right else lead
        ext = jax.lax.dynamic_update_slice(ext, data, (off,))
        segs = [
            ext[i * blk : (i + nw) * blk].reshape(nw, blk)
            for i in range(nseg)
        ]
        win = jnp.concatenate(segs, axis=1)[:, :Lw]
        w = jnp.arange(nw, dtype=jnp.int32) * blk
        real = jnp.clip(n - w, 0, blk)
        lens = (lead + real) if not right else jnp.minimum(n - w, blk + lead)
        return win, lens.astype(jnp.int32), nw

    # -- fused stats ---------------------------------------------------------
    @functools.partial(jax.jit, static_argnames=("self", "n"))
    def _stats_impl(self, data, *, n: int):
        win, lens, nw = self._win(data, n, right=False)
        cnt, first, last, _, _ = self.cs.match_stats_b(
            win, lens.reshape(-1, 1), seeded=True, lead=self.lead
        )
        cnt = cnt.reshape(-1)[:nw]
        first = first.reshape(-1)[:nw]
        last = last.reshape(-1)[:nw]
        blk = self.window_block(n)
        off = jnp.arange(nw, dtype=jnp.int32) * blk - self.lead
        big = jnp.iinfo(jnp.int32).max
        gfirst = jnp.min(jnp.where(first >= 0, first + off, big))
        glast = jnp.max(jnp.where(last >= 0, last + off, -1))
        total = jnp.sum(cnt)
        return total, jnp.where(total > 0, gfirst, -1), glast

    @staticmethod
    def _data(text):
        if isinstance(text, (bytes, bytearray)):
            return jnp.asarray(np.frombuffer(text, np.uint8)), len(text)
        return jnp.asarray(text), int(text.shape[0])

    def long_stats(self, text):
        """(count, first_end, last_end) over the whole string, one batched
        device pass."""
        data, n = self._data(text)
        if self.prog.nullable:  # empty match at every position
            return n + 1, 0, n
        if n == 0:
            return 0, -1, -1
        total, first, last = self._stats_impl(data, n=n)
        return int(total), int(first), int(last)

    def _run(self, text, seeded: bool, mode: str):
        """Device-value variant for pipelined callers (bench harness).

        Duck-types ``FastLongScanner._run`` for the modes this tier
        supports: seeded count/any and unseeded fullmatch. Returns the
        un-synced device scalar so K scans can be in flight."""
        data, n = self._data(text)
        if mode == "full":
            return self._full_value(data, n)
        if not seeded or mode not in ("count", "any"):
            raise ValueError(
                f"CountLongScanner._run: unsupported (seeded={seeded}, "
                f"mode={mode!r}) — counting tier has no flag stream"
            )
        total, _, _ = self._stats_impl(data, n=n)
        return total if mode == "count" else total > 0

    def count_ends(self, text) -> int:
        return self.long_stats(text)[0]

    def search(self, text) -> bool:
        return self.count_ends(text) > 0

    def _full_value(self, data, n: int):
        """Whole-string acceptance as a device (or python) bool scalar."""
        if n == 0:
            return jnp.bool_(self.prog.nullable)
        k, mm = self.k, max(self.m, 1)
        j = n // k
        if n % k or j < mm or (self.n and j > self.n):
            return jnp.bool_(False)
        from .scan_count import _in_class

        # copy c (bytes c*k..c*k+k-1) must match SOME branch; the whole
        # string matches iff every copy does
        occ = None
        for br in self.body:
            bok = None
            for q in range(k):
                d = data[q::k].astype(jnp.int32)
                t = _in_class(d, br[q])
                bok = t if bok is None else (bok & t)
            occ = bok if occ is None else (occ | bok)
        return jnp.all(occ)

    def fullmatch(self, text) -> bool:
        data, n = self._data(text)
        return bool(self._full_value(data, n))

    # -- bitmaps (ends / candidate starts over the global stream) ----------
    @functools.partial(jax.jit, static_argnames=("self", "n"))
    def _ends_impl(self, data, *, n: int):
        win, lens, nw = self._win(data, n, right=False)
        fl = self.cs.forward_flags_b(
            win, lens.reshape(-1, 1), seeded=True
        )  # [nw, Lw + 3] bool, column c = accept at step tg = c - 1
        lead, blk = self.lead, self.window_block(n)
        # window-local ends e = tg in (lead, lead + blk] own the global
        # positions w*blk + (e - lead); column c = e + 1
        return fl[:nw, lead + 2 : lead + 2 + blk].reshape(-1)[: max(n, 1)]

    def ends_bitmap(self, text) -> np.ndarray:
        """[n+1] bool; bit e = some match ends at e."""
        data, n = self._data(text)
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        out = np.zeros(n + 1, bool)
        if n:
            out[1:] = np.asarray(self._ends_impl(data, n=n))[:n]
        return out

    @functools.partial(jax.jit, static_argnames=("self", "n"))
    def _starts_impl(self, data, *, n: int):
        win, lens, nw = self._win(data, n, right=True)
        h = self.cs.reverse_hits_b(
            win, lens.reshape(-1, 1)
        )  # [nw, T] bool, step tg = a match starts at window byte tg-1
        return h[:nw, 1 : 1 + self.window_block(n)].reshape(-1)[: max(n, 1)]

    def starts_bitmap(self, text) -> np.ndarray:
        """[n+1] bool; bit s = some match starts at s (candidate starts
        for span extraction, Pattern.finditer_long)."""
        data, n = self._data(text)
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        out = np.zeros(n + 1, bool)
        if n:
            out[:n] = np.asarray(self._starts_impl(data, n=n))[:n]
        return out

    # -- closed-form span extraction ----------------------------------------
    def _copies_from(self, arr: np.ndarray) -> np.ndarray:
        """[n] int64: number of consecutive body copies starting at each
        position (run-length analysis, no scan kernels)."""
        n = arr.shape[0]
        k = self.k
        nocc = max(n - k + 1, 0)
        occ = np.zeros(nocc, bool)
        for br in self.body:  # copy starts here iff SOME branch matches
            bok = np.ones(nocc, bool)
            for q, runs in enumerate(br):
                a = arr[q : q + nocc]
                ok = np.zeros(nocc, bool)
                for lo, hi in runs:
                    ok |= (a >= lo) & (a <= hi)
                bok &= ok
            occ |= bok
        C = np.zeros(n + k, np.int64)  # C[s] = occ[s] ? 1 + C[s+k] : 0
        for r in range(k):  # suffix recurrence, vectorized per phase
            o = occ[r::k] if r < occ.shape[0] else np.zeros(0, bool)
            m = o.shape[0]
            if not m:
                continue
            # run length to the right within the phase: distance to the
            # next False (nxt is sorted; searchsorted finds it per index)
            nxt = np.where(~o)[0]
            if len(nxt):
                pos = np.searchsorted(nxt, np.arange(m), side="left")
                safe = np.minimum(pos, len(nxt) - 1)
                bound = np.where(pos < len(nxt), nxt[safe], m)
            else:
                bound = np.full(m, m, np.int64)
            C[r::k][:m] = bound - np.arange(m)
        return C[:n]

    def spans(self, text, *, longest: bool = False):
        """Non-overlapping spans (oracle finditer policy) in closed form:
        a lazy match from start s is always exactly m body copies, a
        greedy one min(copies(s), n) copies — so the whole enumeration is
        a host walk over the copies array. Works for unbounded ``X{m,}``
        too (no finite horizon needed). Nullable patterns fall back to
        the generic per-candidate path (Pattern.finditer_long handles
        them before calling this)."""
        assert not self.prog.nullable, "nullable spans handled by caller"
        if isinstance(text, (bytes, bytearray)):
            arr = np.frombuffer(text, np.uint8)
        else:
            arr = np.asarray(text, np.uint8)
        n = arr.shape[0]
        k, mm = self.k, max(self.m, 1)
        C = self._copies_from(arr)
        starts = np.where(C >= mm)[0]
        out = []
        p = 0
        i = 0
        M = starts.shape[0]
        while i < M:
            s = int(starts[i])
            cap = int(C[s]) if not self.n else min(int(C[s]), self.n)
            e = s + (cap if longest else mm) * k
            out.append((s, e))
            p = e
            i = int(np.searchsorted(starts, p, side="left"))
        return out


def dotstar_core(prog: DeviceProgram):
    """(core_prog, had_trailing_dotstar) for `.*X.*`-shaped patterns, or
    None. Under SEEDED ends semantics a leading ``.*`` is redundant (a
    match may start anywhere already) and a trailing ``.*`` turns the
    ends set into a segmented running-OR of X's ends (segments break at
    dead >= 0x80 bytes, which ``.`` does not match) — so the cyclic
    automaton of the BASELINE-config-2 class (``.*error.*``) never needs
    the summary+replay mode: scan the bounded-horizon core X at the
    overlapped-window rate and apply a cheap vector epilogue. X must be
    non-nullable (a nullable X makes the whole pattern nullable, which
    callers already special-case)."""
    from ..compiler.nfa import build_nfa_ast
    from ..compiler.parser import Concat, Lit, Repeat, parse
    from ..compiler.program import compile_program

    try:
        node = parse(prog.pattern)
    except Exception:
        return None
    parts = list(node.parts) if isinstance(node, Concat) else [node]
    any_syms = frozenset(range(0x80))

    def is_ds(nd):
        return (
            isinstance(nd, Repeat)
            and nd.lo == 0
            and nd.hi is None
            and isinstance(nd.child, Lit)
            and nd.child.syms == any_syms
        )

    lead = 0
    while lead < len(parts) and is_ds(parts[lead]):
        lead += 1
    trail = 0
    while len(parts) - lead - trail > 0 and is_ds(parts[-1 - trail]):
        trail += 1
    if (lead == 0 and trail == 0) or len(parts) - lead - trail < 1:
        return None
    core_parts = tuple(parts[lead : len(parts) - trail])
    core_ast = core_parts[0] if len(core_parts) == 1 else Concat(core_parts)
    try:
        nfa = build_nfa_ast(core_ast, f"<core:{prog.pattern}>")
    except Exception:
        return None
    if nfa.nullable:
        return None
    core = compile_program(nfa)
    if core.uses_anchor:
        # BOS/EOS inside the core interacts with the stripped context
        # (e.g. `.*^a`): keep those on the generic scanners
        return None
    return core, trail > 0


class DotStarLongScanner:
    """Seeded long-string scan for `.*X.*` rewrites (see dotstar_core).

    count/any/ends run as: inner scan of X (overlapped/counting windows)
    → device ends bitmap → trailing-``.*`` running-OR epilogue. Fullmatch
    and unseeded scans delegate to a generic scanner for the ORIGINAL
    pattern (the rewrite is exact only for the seeded ends set)."""

    def __init__(self, prog, core_prog, trail: bool, block: int = 16384):
        self.prog = prog
        self.core_prog = core_prog
        self.trail = trail
        self.block = block
        self.inner = make_long_scanner(core_prog, block)
        self.overlap = getattr(self.inner, "overlap", None)
        self._generic = None

    def _fallback(self):
        if self._generic is None:
            if self.prog.F is not None:
                self._generic = FastLongScanner(self.prog, block=self.block)
            else:
                self._generic = LongScanner(self.prog, block=4096)
        return self._generic

    @staticmethod
    def _data(text):
        if isinstance(text, (bytes, bytearray)):
            return jnp.asarray(np.frombuffer(text, np.uint8)), len(text)
        return jnp.asarray(text), int(text.shape[0])

    def _ends_post(self, data, *, n: int, mode: str):
        """Plain orchestration (not jitted: the inner scanners own their
        jit caches); returns un-synced device values so callers can
        pipeline."""
        ends = self._inner_ends(data, n)
        return self._epilogue(ends, data, n=n, mode=mode)

    def _inner_ends(self, data, n: int):
        inner = self.inner
        # inner ends bitmap [n+1] on device (e = 0 impossible: core is
        # non-nullable)
        if isinstance(inner, CountLongScanner):
            if n:
                body = inner._ends_impl(data, n=n)[:n]
                ends = jnp.concatenate(
                    [jnp.zeros(1, bool), body.astype(bool)]
                )
            else:
                ends = jnp.zeros(1, bool)
        else:
            if isinstance(inner, LongScanner):
                flags = scan_long(
                    inner.tables, data, length=n, block=inner.block,
                    seeded=True, bos_class=self.core_prog.bos_class,
                    eos_class=self.core_prog.eos_class,
                )
            else:
                flags = inner._run(data, True, "flags")  # [n+2] by step
            f = flags[: n + 2] > 0
            ends = f[: n + 1]
            ends = ends.at[n].set(ends[n] | f[n + 1])
        return ends

    @functools.partial(jax.jit, static_argnames=("self", "n", "mode"))
    def _epilogue(self, ends, data, *, n: int, mode: str):
        if not (self.trail and n):
            if mode == "count":
                return jnp.sum(ends.astype(jnp.int32))
            if mode == "any":
                return jnp.any(ends)
            return ends
        if mode == "any":
            # a trailing .* can be empty: any X end IS a P end
            return jnp.any(ends)
        dead = data[:n] >= 0x80

        def general(_):
            """Segmented running-OR: e is a P end iff some X end e' <= e
            with no dead byte in [e', e). O(n log n) cummax passes —
            reached only when the text actually contains dead bytes."""
            e_idx = jnp.arange(n + 1, dtype=jnp.int32)
            last_end = jax.lax.cummax(jnp.where(ends, e_idx, -1))
            dd = jnp.where(dead, jnp.arange(1, n + 1, dtype=jnp.int32), 0)
            D = jnp.concatenate(
                [jnp.zeros(1, jnp.int32), jax.lax.cummax(dd)]
            )
            return (last_end >= 0) & (last_end >= D)

        if mode == "ends":
            return general(None)
        # count with the single-segment fast path (pure-ASCII text — the
        # overwhelmingly common case): every e >= first X end is a P end
        first = jnp.argmax(ends).astype(jnp.int32)
        cnt_fast = jnp.where(jnp.any(ends), n + 1 - first, 0)
        return jax.lax.cond(
            jnp.any(dead),
            lambda _: jnp.sum(general(None).astype(jnp.int32)),
            lambda _: cnt_fast,
            None,
        )

    @functools.partial(jax.jit, static_argnames=("self", "n"))
    def _count_trail_impl(self, data, *, n: int):
        """Trailing-``.*`` count with a DEVICE-RESIDENT dead-byte
        verdict: on pure-ASCII text (the common case) every e >= the
        global FIRST core end is a P end, and that first is exactly the
        window stats' `first` reduction — no flag stream at all.
        Text containing dead (>= 0x80) bytes keeps the segmented
        running-OR over the flag stream; lax.cond selects on device so
        back-to-back scans pipeline with no per-call host sync (the
        speculative-window verdict pattern)."""
        dead = data[:n] >= 0x80

        def fast(_):
            _, anyg, firstg = self.inner._window_stats(data, n=n)
            return jnp.where(
                anyg, n + 1 - firstg.astype(jnp.int32), 0
            )

        def slow(_):
            flags = self.inner._window_flags(data, n=n)
            f = flags[: n + 2] > 0
            ends = f[: n + 1].at[n].set(f[n] | f[n + 1])
            e_idx = jnp.arange(n + 1, dtype=jnp.int32)
            last_end = jax.lax.cummax(jnp.where(ends, e_idx, -1))
            dd = jnp.where(dead, jnp.arange(1, n + 1, dtype=jnp.int32), 0)
            D = jnp.concatenate(
                [jnp.zeros(1, jnp.int32), jax.lax.cummax(dd)]
            )
            return jnp.sum(
                ((last_end >= 0) & (last_end >= D)).astype(jnp.int32)
            )

        return jax.lax.cond(jnp.any(dead), slow, fast, None)

    def _run(self, text, seeded: bool, mode: str):
        """FastLongScanner._run duck type (bench pipelining): un-synced
        device values for seeded count/any; everything else generic."""
        if seeded and mode in ("count", "any"):
            if not self.trail and hasattr(self.inner, "_run"):
                # no trailing .*: P's ends ARE the core's ends — take the
                # inner scanner's fastest stats path directly (overlapped
                # or counting windows), no flag stream needed
                return self.inner._run(text, seeded, mode)
            data, n = self._data(text)
            if mode == "any":
                # a trailing .* can be empty: any core end IS a P end, so
                # the inner scanner's any path answers directly
                if hasattr(self.inner, "_run"):
                    return self.inner._run(text, seeded, "any")
            elif (
                n > 0
                and isinstance(self.inner, FastLongScanner)
                and self.inner.overlap is not None
            ):
                return self._count_trail_impl(data, n=n)
            return self._ends_post(data, n=n, mode=mode)
        return self._fallback()._run(text, seeded, mode)

    def ends_bitmap(self, text) -> np.ndarray:
        data, n = self._data(text)
        if self.prog.nullable:
            return np.ones(n + 1, bool)
        return np.asarray(self._ends_post(data, n=n, mode="ends"))

    def count_ends(self, text) -> int:
        if self.prog.nullable:
            return self._data(text)[1] + 1
        return int(self._run(text, True, "count"))

    def search(self, text) -> bool:
        if self.prog.nullable:
            return True
        return bool(self._run(text, True, "any"))

    def fullmatch(self, text) -> bool:
        return bool(self._fallback().fullmatch(text))

    def starts_bitmap(self, text) -> np.ndarray:
        return self._fallback().starts_bitmap(text)

    def flags(self, text, *, seeded: bool = True):
        return self._fallback().flags(text, seeded=seeded)


class AliasLongScanner(DotStarLongScanner):
    """Long-string scans for whole-pattern X{m,n} blowups via the X{m,}
    seeded alias (engine.seeded_alias_program): ends AND starts are
    identical under seeded semantics, so count/search/bitmaps run on the
    small alias automaton; fullmatch keeps the original
    program (the bound is observable there)."""

    def __init__(self, prog, core_prog, block: int = 16384):
        super().__init__(prog, core_prog, trail=False, block=block)

    def starts_bitmap(self, text) -> np.ndarray:
        # starts(X{m,n}) == starts(X{m,}) (prefix sub-chains), but the
        # alias is cyclic so the reverse overlapped pass may refuse;
        # surface that as the same bounded-horizon error callers already
        # handle (Pattern.finditer_long gates on `overlap` first)
        inner = self.inner
        if hasattr(inner, "starts_bitmap"):
            return inner.starts_bitmap(text)
        raise ValueError(
            "start extraction over one long string needs a bounded-horizon "
            f"scanner; {self.prog.pattern!r} routes through the cyclic "
            "X{m,} alias — use the batched record API for spans"
        )


def make_long_scanner(prog: DeviceProgram, block: int = 16384):
    """Best available long-string scanner for this program: `.*X.*` and
    X{m,n}-blowup rewrites first, run-length windows for counting-plan
    patterns, overlapped windows through the batch route for dense
    tiers (summary+replay where windows are not exact), portable XLA
    otherwise."""
    from .scan_count import counting_plan

    if not prog.nullable and prog.horizon is None:
        ds = dotstar_core(prog)
        if ds is not None:
            core_prog, trail = ds
            if core_prog.horizon is not None or counting_plan(core_prog):
                return DotStarLongScanner(prog, core_prog, trail, block)
    if prog.tier in ("multiblock", "sparse") and not prog.nullable:
        from ..engine import seeded_alias_program

        aprog = seeded_alias_program(prog)
        if aprog is not None:
            return AliasLongScanner(prog, aprog, block)

    # counting-plan patterns always prefer the run-length windows in long
    # mode: X{m,} (cyclic) would otherwise fall to the summary path
    plan = counting_plan(prog)
    if plan is not None:
        m, _, branches = plan
        if max(m, 1) * len(branches[0]) <= 1 << 16:
            return CountLongScanner(prog, plan, block=max(block, 32768))
    if prog.F is not None:
        if prog.s_tile <= 32:
            return FastLongScanner(prog, block=block)
        # wide tiles: overlapped windows when the horizon is bounded;
        # grow the block so the overlap fits
        if prog.horizon is not None and not prog.uses_anchor:
            blk = max(block, -(-8 * (prog.horizon + 2) // 128) * 128)
            return FastLongScanner(prog, block=blk)
    return LongScanner(prog, block=min(block, 4096))
