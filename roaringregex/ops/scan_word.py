"""Word scan: one record per thread, its state set in one ``uint32``.

The reference's ``BitSet<1>`` word tier (BitSet.h:9-41, selected at
Parser.cpp:165-168) as a Pallas-Triton kernel for the GPU. It serves
``match_stats_b`` (count, first end, last end, full match, any) for every
dense program of at most 32 states, multi-pattern combined automata with
accept channels included. Count, search, fullmatch and grep all reduce to
it.

* **Layout.** Bytes go time-major as ``uint32`` words (``[L4 // 4, B_pad]``,
  one pad + bitcast + transpose in XLA): each step's load is contiguous
  across the program's block of records, and one load feeds four steps.
* **Kernel.** Each program owns ``BLK`` records (one per thread) and runs a
  ``fori_loop`` over the byte words of its block; the loop stops at the
  block's longest record. A record's state set, its previous-step accept
  flags and its per-channel (count, first step, last step) stay in
  registers and are stored once at the end.
* **Step.** Byte -> gate is range compares from ``WordSpec.gates``,
  unrolled at trace time (no gathers); the transition is
  ``nxt |= where(gate, (v << d) & mask, 0)`` over ``WordSpec.dg``, the
  (diagonal, gate) decomposition of the static follow matrix
  (NFA.cc:86-100's per-byte row union).

Stream convention (shared with ops/scan_xla.py): step 0 is BOS, step
``j + 1`` consumes byte ``j``, step ``len + 1`` is EOS, later steps are
dead; the match end of step ``t`` is ``min(t, len)``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .. import platform
from ..compiler.program import DeviceProgram

MAX_DG_OPS = 64  # (delta, gate) pairs past this: the packed engine wins
BLK = 128  # records per program (one per thread)
NUM_WARPS = 4


class WordSpec(NamedTuple):
    """Static per-program plan (hashable: jit/pallas static arg)."""

    # deduped byte-set gates: (((lo, hi), ...) merged runs, bos, eos)
    gates: Tuple[Tuple[Tuple[Tuple[int, int], ...], bool, bool], ...]
    # (delta, ((gate_index, target_bitmask), ...)): the step applies
    # nxt |= where(gate, (v << delta) & mask, 0) per pair
    dg: Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]
    acc_masks: Tuple[int, ...]  # per accept channel: bitmask of states
    has_eos: bool
    has_bos: bool
    S: int


def _merge_runs(runs):
    out = []
    for lo, hi in sorted(runs):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def word_spec(
    prog: DeviceProgram,
    accept_map: Optional[np.ndarray] = None,
    P: int = 1,
) -> Optional[WordSpec]:
    """Build the u32-word plan, or None if the program doesn't qualify.

    ``accept_map`` ([lanes, G * P] 0/1) supplies per-channel accept masks
    for multi-pattern programs (channel p's states are rows of the first
    record tile, engine accept_map construction in api.MultiPattern)."""
    if prog.tier == "sparse" or prog.F is None or prog.s_tile > 32:
        return None
    S = prog.s_tile
    F = np.asarray(prog.F[:S, :S])
    Bw = [int(w[0]) & 0xFFFFFFFF for w in np.asarray(prog.Bc_words)]
    lo, hi, cl = prog.byte_runs
    if len(hi) and int(max(hi)) > 0x7F:
        return None
    runs_all = [(int(l), int(h), int(c)) for l, h, c in zip(lo, hi, cl)]
    bos_c = prog.bos_class if Bw[prog.bos_class] else -1
    eos_c = prog.eos_class if Bw[prog.eos_class] else -1
    gate_ids = {}
    gates = []
    pairs = {}
    has_eos = has_bos = False
    for u in range(S):
        preds = [int(s) for s in range(S) if F[s, u]]
        if not preds:
            continue
        cs = {c for c, w in enumerate(Bw) if (w >> u) & 1}
        if not cs:
            continue
        key = (
            _merge_runs([(l, h) for l, h, c in runs_all if c in cs]),
            bos_c in cs,
            eos_c in cs,
        )
        has_bos = has_bos or key[1]
        has_eos = has_eos or key[2]
        gid = gate_ids.get(key)
        if gid is None:
            gid = gate_ids[key] = len(gates)
            gates.append(key)
        for s in preds:
            k = (u - s, gid)
            pairs[k] = pairs.get(k, 0) | (1 << u)
    if len(pairs) > MAX_DG_OPS:
        return None
    by_d = {}
    for (d, gid), mask in sorted(pairs.items()):
        by_d.setdefault(d, []).append((gid, mask))
    dg = tuple((d, tuple(ps)) for d, ps in sorted(by_d.items()))
    if accept_map is not None:
        A = np.asarray(accept_map)
        acc_masks = []
        for p in range(P):
            m = 0
            for s in range(S):
                if A[s, p]:
                    m |= 1 << s
            acc_masks.append(m)
    else:
        acc = np.asarray(prog.accept)[:S]
        acc_masks = [sum(1 << s for s in range(S) if acc[s])]
    return WordSpec(
        tuple(gates), dg, tuple(acc_masks), has_eos, has_bos, S
    )


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def _word_kernel(
    len_ref,  # [BLK] int32 record lengths
    w_ref,  # [n_words, BLK] uint32: word w holds bytes 4w..4w+3
    cnt_ref,  # [P, BLK] int32 emitted accept steps
    first_ref,  # [P, BLK] int32 first emitting step (-1: none)
    last_ref,  # [P, BLK] int32 last emitting step (-1: none)
    *,
    spec: WordSpec,
    seeded: bool,
    lead: int,
    n_words: int,
):
    u32, i32 = jnp.uint32, jnp.int32
    P = len(spec.acc_masks)
    lens = len_ref[...]
    zero = jnp.zeros(lens.shape, u32)
    ones = lens >= 0  # all-true bool vector of the block's shape

    def gates_of(d, alive, bos, eosb):
        out = []
        for runs, bosf, eosf in spec.gates:
            g = None
            if d is not None:
                for lo, hi in runs:
                    t = (d >= lo) & (d <= hi)
                    g = t if g is None else g | t
                g = g & alive if g is not None else None
            if bosf and bos:
                g = ones if g is None else g | ones
            if eosf and eosb is not None:
                g = eosb if g is None else g | eosb
            out.append(g)
        return out

    def advance(v, gates, inject):
        if inject is True:
            vv = v | u32(1)
        else:
            vv = jnp.where(inject, v | u32(1), v)
        nxt = zero
        for dlt, ps in spec.dg:
            if dlt > 0:
                sh = vv << u32(dlt)
            elif dlt < 0:
                sh = vv >> u32(-dlt)
            else:
                sh = vv
            for gid, mask in ps:
                g = gates[gid]
                if g is not None:
                    nxt = nxt | jnp.where(g, sh & u32(mask), u32(0))
        return nxt

    def record(nxt, eosb, tg, st):
        v, prev, cnt, first, last = st
        prev, cnt, first, last = list(prev), list(cnt), list(first), list(last)
        for p in range(P):
            fl = (nxt & u32(spec.acc_masks[p])) != 0
            emit = fl
            if spec.has_eos:
                # the EOS step's accept duplicates end == len when the
                # final byte step already flagged; emit only if new
                if eosb is not None:
                    emit = fl & ~(prev[p] & eosb)
                prev[p] = fl
            if lead:
                emit = emit & (tg > lead)
            cnt[p] = cnt[p] + emit.astype(i32)
            first[p] = jnp.where((first[p] < 0) & emit, tg, first[p])
            last[p] = jnp.where(emit, tg, last[p])
        return (nxt, tuple(prev), tuple(cnt), tuple(first), tuple(last))

    neg = jnp.full(lens.shape, -1, i32)
    st = (
        zero,
        tuple(~ones for _ in range(P)),
        tuple(jnp.zeros(lens.shape, i32) for _ in range(P)),
        (neg,) * P,
        (neg,) * P,
    )
    # step 0: BOS (no byte, no EOS; both seeding conventions inject)
    nxt = advance(zero, gates_of(None, None, True, None), True)
    st = record(nxt, None, 0, st)

    def body(w, st):
        word = w_ref[w]
        for q in range(4):
            j = 4 * w + q
            d = ((word >> u32(8 * q)) & u32(0xFF)).astype(i32)
            eosb = (lens == j) if spec.has_eos else None
            gates = gates_of(d, lens > j, False, eosb)
            inject = True if seeded else (j == 0)
            nxt = advance(st[0], gates, inject)
            st = record(nxt, eosb, j + 1, st)
        return st

    # every step past the block's longest EOS is dead
    n_live = jnp.minimum(jnp.max(lens) // 4 + 1, n_words)
    st = jax.lax.fori_loop(0, n_live, body, st)
    _, _, cnt, first, last = st
    for p in range(P):
        cnt_ref[p] = cnt[p]
        first_ref[p] = first[p]
        last_ref[p] = last[p]


def _finish(cnt, first_tl, last_tl, ln, *, nullable: bool, seeded: bool):
    """Raw per-step kernel outputs -> (cnt, first, last, full, any), the
    scan_xla.match_stats semantics (end of step t is min(t, len))."""
    anyf = cnt > 0
    full = anyf & (last_tl >= ln)
    if nullable:
        full = full | (ln == 0)
        first = jnp.zeros_like(ln)
        if seeded:
            cnt = ln + 1
            last = jnp.where(last_tl < 0, ln, jnp.minimum(last_tl, ln))
        else:
            step0 = (first_tl == 0).astype(jnp.int32)
            cnt = jnp.where(ln == 0, 1, 1 + cnt - step0)
            last = jnp.maximum(
                jnp.minimum(jnp.where(last_tl < 0, 0, last_tl), ln), 0
            )
    else:
        first = jnp.where(first_tl < 0, -1, jnp.minimum(first_tl, ln))
        last = jnp.where(last_tl < 0, -1, jnp.minimum(last_tl, ln))
    return cnt, first, last, full, cnt > 0


# ---------------------------------------------------------------------------
# Scanner
# ---------------------------------------------------------------------------


class WordScanner:
    """``match_stats_b`` through the word kernel. Built by the engine, the
    mesh scanner and the long-string window scanner when
    ``platform.route`` picks the ``word`` kernel."""

    def __init__(self, prog, accept_map=None, P: int = 1, nullable=None):
        self.prog = prog
        self.wspec = word_spec(prog, accept_map=accept_map, P=P)
        if self.wspec is None:
            raise ValueError(f"{prog.pattern!r} does not fit the word tier")
        self.P = P
        self.nullable = prog.nullable if nullable is None else nullable

    # value identity: scanners of the same plan (every engine rebuilt over
    # one pattern) share one entry of the jit cache below
    def __hash__(self):
        return hash((self.wspec, self.P, self.nullable))

    def __eq__(self, other):
        return (
            isinstance(other, WordScanner)
            and (self.wspec, self.P, self.nullable)
            == (other.wspec, other.P, other.nullable)
        )

    def match_stats_b(self, data, len_g, *, seeded: bool, lead: int = 0):
        """(cnt, first, last, full, any), each [B_rows, G * P], for a raw
        [B_rows * G, L] byte batch. ``lead``: accepts at steps <= lead are
        ignored (the overlapped-window gate: those ends belong to the
        previous window)."""
        len_g = jnp.asarray(len_g)
        B_rows, G = len_g.shape
        out = self._call(
            jnp.asarray(data),
            len_g.reshape(-1).astype(jnp.int32),
            seeded=seeded,
            lead=lead,
        )
        return tuple(x.reshape(B_rows, G * self.P) for x in out)

    @functools.partial(jax.jit, static_argnames=("self", "seeded", "lead"))
    def _call(self, data, lengths, *, seeded: bool, lead: int):
        R, L = data.shape
        B_pad = -(-max(R, 1) // BLK) * BLK
        L4 = -(-(L + 1) // 4) * 4  # EOS step of a full-length record fits
        dp = jnp.pad(data, ((0, B_pad - R), (0, L4 - L)))
        words = jax.lax.bitcast_convert_type(
            dp.reshape(B_pad, L4 // 4, 4), jnp.uint32
        ).T  # [L4 // 4, B_pad], time-major
        ln = jnp.pad(lengths, (0, B_pad - R))
        P = self.P
        n_words = L4 // 4
        kernel = functools.partial(
            _word_kernel,
            spec=self.wspec,
            seeded=seeded,
            lead=lead,
            n_words=n_words,
        )
        out_spec = pl.BlockSpec((P, BLK), lambda i: (0, i))
        cnt, first_tl, last_tl = pl.pallas_call(
            kernel,
            out_shape=[jax.ShapeDtypeStruct((P, B_pad), jnp.int32)] * 3,
            grid=(B_pad // BLK,),
            in_specs=[
                pl.BlockSpec((BLK,), lambda i: (i,)),
                pl.BlockSpec((n_words, BLK), lambda i: (0, i)),
            ],
            out_specs=[out_spec] * 3,
            compiler_params=pltriton.CompilerParams(
                num_warps=NUM_WARPS, num_stages=1
            ),
            backend="triton",
            interpret=platform.interpret(),
            name="rrx_word_scan",
        )(ln, words)
        outs = _finish(
            cnt.T, first_tl.T, last_tl.T, ln[:, None],
            nullable=self.nullable, seeded=seeded,
        )  # each [B_pad, P], record-major
        return tuple(x[:R] for x in outs)
