"""Pure-XLA scan engine: the portable implementation of the NFA step.

This is the semantics-complete compute path that runs on any JAX backend
and any tier; every other path must agree with it and with the oracle.

The per-step transition uses the fused-matmul formulation (see
``compiler/program.py``): one batched 0/1 matrix product per input symbol
computes both the byte-independent follow expansion and the symbol mask:

    u   = [v | onehot(class)]            # [B, s_pad + c_pad]
    acc = u @ [[F], [K * Bc]]            # [B, s_pad], fp32 accum (exact)
    v'  = acc > K                        # follow(v) & B[class]

Stream convention (normative; mirrors oracle/engine.py):

* column 0 is BOS; columns 1..n are the record's bytes (as alphabet-class
  ids); column n+1 is EOS; remaining columns are the dead class.
* step t (1-based) consumes column t-1; the real end position after step t
  is ``min(t-1, n)``.
* seeding the initial state into the input of step t models a match start
  at position ``max(t-2, 0)``; anchored-at-0 scans seed steps 1 and 2 (both
  sides of BOS), seeded scans seed every step.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler.program import DeviceProgram

Tables = Dict[str, jnp.ndarray]

# Compute dtype for the fused matmul: bf16 holds {0, 1, K} exactly (K is a
# power of two) and every product accumulates in fp32, so all sums
# (<= s_pad + K < 2^24) are exact integers on any matmul unit.
DTYPE = jnp.bfloat16


def device_tables(prog: DeviceProgram) -> Tables:
    """Move a compiled program's tables to device arrays (replicable pytree)."""
    if prog.F is not None:
        F = prog.F
    else:
        F = _dense_from_blocks(prog)
    # fuse threshold: power of two > max possible row sum of v @ F (i.e.
    # > s_pad); exactly representable in bf16 at any size
    fuse_k = 1 << (prog.s_pad + 1).bit_length()
    M = np.concatenate([F, fuse_k * prog.Bc.astype(np.int32)], axis=0)
    return {
        "K": jnp.asarray(fuse_k, jnp.float32),
        "M": jnp.asarray(M, DTYPE),  # [s_pad + c_pad, s_pad]
        "F": jnp.asarray(F, DTYPE),
        "Ft": jnp.asarray(F.T, DTYPE),
        "Bc": jnp.asarray(prog.Bc, DTYPE),  # [c_pad, s_pad]
        "accept": jnp.asarray(prog.accept, DTYPE),  # [s_pad]
        "byte_class": jnp.asarray(prog.byte_class, jnp.int32),  # [256]
    }


def _dense_from_blocks(prog: DeviceProgram) -> np.ndarray:
    from ..compiler.program import BLOCK

    F = np.zeros((prog.s_pad, prog.s_pad), dtype=np.uint8)
    for blk, bi, bj in zip(prog.fblocks, prog.fblock_rows, prog.fblock_cols):
        F[bi * BLOCK : (bi + 1) * BLOCK, bj * BLOCK : (bj + 1) * BLOCK] = blk
    return F


# ---------------------------------------------------------------------------
# Stream encoding
# ---------------------------------------------------------------------------


def encode_stream(
    tables: Tables,
    data: jnp.ndarray,  # [B, L] uint8/int32 raw bytes (padded arbitrarily)
    lengths: jnp.ndarray,  # [B] int32
    bos_class: int,
    eos_class: int,
    dead_class: int,
) -> jnp.ndarray:
    """Build the [B, L+2] class-id stream: BOS | classes | EOS | dead..."""
    B, L = data.shape
    cls = jnp.take(tables["byte_class"], data.astype(jnp.int32), axis=0)
    j = jnp.arange(L)[None, :]
    n = lengths[:, None]
    body = jnp.where(j < n, cls, jnp.where(j == n, eos_class, dead_class))
    # column for position L (EOS if the record fills the buffer)
    tailcol = jnp.where(lengths == L, eos_class, dead_class)[:, None]
    boscol = jnp.full((B, 1), bos_class, jnp.int32)
    return jnp.concatenate([boscol, body.astype(jnp.int32), tailcol], axis=1)


# ---------------------------------------------------------------------------
# Forward scan
# ---------------------------------------------------------------------------


def _step(tables: Tables, v: jnp.ndarray, cls_t: jnp.ndarray) -> jnp.ndarray:
    c_pad = tables["Bc"].shape[0]
    oh = (cls_t[:, None] == jnp.arange(c_pad)[None, :]).astype(DTYPE)
    u = jnp.concatenate([v, oh], axis=1)
    acc = jnp.dot(u, tables["M"], preferred_element_type=jnp.float32)
    return (acc > tables["K"]).astype(DTYPE)


@functools.partial(jax.jit, static_argnames=("seeded", "n_seed_steps"))
def forward_flags(
    tables: Tables,
    cls: jnp.ndarray,  # [B, T] int32 stream
    *,
    seeded: bool,
    n_seed_steps: int = 2,
) -> jnp.ndarray:
    """Run the scan; return accept flags [B, T+1] where flags[:, t] is the
    acceptance of the state set after t steps (flags[:, 0] = nullable for
    anchored scans / handled by caller for seeded)."""
    B, T = cls.shape
    s_pad = tables["accept"].shape[0]
    v0 = jnp.zeros((B, s_pad), DTYPE).at[:, 0].set(1)

    def body(v, xs):
        cls_t, t = xs
        seed = jnp.where(
            jnp.asarray(seeded) | (t < n_seed_steps), jnp.asarray(1, DTYPE), v[:, 0]
        )
        v = v.at[:, 0].set(seed)
        v2 = _step(tables, v, cls_t)
        flag = jnp.dot(v2, tables["accept"], preferred_element_type=jnp.float32) > 0
        return v2, flag

    _, flags = jax.lax.scan(body, v0, (cls.T, jnp.arange(T)))
    flag0 = jnp.broadcast_to(tables["accept"][0] > 0, (1, B))
    return jnp.concatenate([flag0, flags], axis=0).T  # [B, T+1]


def end_positions(T_plus_1: int, lengths: jnp.ndarray) -> jnp.ndarray:
    """e[b, t] = real end position after t steps = clamp(t-1, 0, len_b)."""
    t = jnp.arange(T_plus_1)[None, :]
    return jnp.clip(t - 1, 0, lengths[:, None])


def ends_bitmap(
    flags: jnp.ndarray,  # [B, T+1] bool
    lengths: jnp.ndarray,
    max_len: int,
    nullable: bool,
    seeded: bool,
) -> jnp.ndarray:
    """[B, max_len+1] bool: some match ends at position e."""
    B, T1 = flags.shape
    e = end_positions(T1, lengths)
    out = jnp.zeros((B, max_len + 1), bool)
    out = out.at[jnp.arange(B)[:, None], e].max(flags)
    if nullable and seeded:
        # a fresh seed exists at every position -> empty match everywhere
        valid = jnp.arange(max_len + 1)[None, :] <= lengths[:, None]
        out = out | valid
    return out


@functools.partial(jax.jit, static_argnames=("seeded", "n_seed_steps", "nullable"))
def match_stats(
    tables: Tables,
    cls: jnp.ndarray,
    lengths: jnp.ndarray,
    *,
    seeded: bool,
    nullable: bool,
    n_seed_steps: int = 2,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused scan returning (count, first_end, any) per record without
    materializing flags: count = #distinct end positions with a match."""
    B, T = cls.shape
    s_pad = tables["accept"].shape[0]
    v0 = jnp.zeros((B, s_pad), DTYPE).at[:, 0].set(1)
    cnt0 = jnp.zeros(B, jnp.int32)
    first0 = jnp.full(B, -1, jnp.int32)
    last0 = jnp.full(B, -1, jnp.int32)
    if nullable:
        # empty match at position 0 always exists; under seeding, at every
        # position (and then no step can contribute a new end).
        cnt0 = (lengths + 1) if seeded else (cnt0 + 1)
        first0 = jnp.zeros(B, jnp.int32)
        last0 = lengths if seeded else jnp.zeros(B, jnp.int32)

    def body(carry, xs):
        v, cnt, first, last = carry
        cls_t, t = xs
        seed = jnp.where(
            jnp.asarray(seeded) | (t < n_seed_steps), jnp.asarray(1, DTYPE), v[:, 0]
        )
        v = v.at[:, 0].set(seed)
        v2 = _step(tables, v, cls_t)
        flag = jnp.dot(v2, tables["accept"], preferred_element_type=jnp.float32) > 0
        e = jnp.clip(t, 0, lengths)  # end after consuming column t
        if nullable and seeded:
            new = jnp.zeros_like(flag)  # every end already pre-counted
        else:
            new = flag & (e != last)
        cnt = cnt + new.astype(jnp.int32)
        first = jnp.where((first < 0) & flag, e, first)
        last = jnp.where(flag, e, last)
        return (v2, cnt, first, last), None

    (v, cnt, first, last), _ = jax.lax.scan(
        body, (v0, cnt0, first0, last0), (cls.T, jnp.arange(T))
    )
    return cnt, first, cnt > 0


@functools.partial(jax.jit, static_argnames=("longest",))
def first_end_from(
    tables: Tables,
    cls: jnp.ndarray,  # [B, T] int32 stream
    lengths: jnp.ndarray,  # [B]
    starts: jnp.ndarray,  # [B] int32 match-start position per record; -1 = inactive
    *,
    longest: bool = False,
) -> jnp.ndarray:
    """Anchored scan from a per-record start position: the smallest end e
    such that text[s:e] matches (lazy policy), or with ``longest=True`` the
    largest such e (greedy leftmost-longest, the POSIX policy the reference
    declared but never implemented -- regex.h:150-165, README.md:55); -1 if
    none. (Nullable patterns are handled by the caller -- their lazy end is
    always s.)

    Seeding rule: start s corresponds to seeding the initial state into the
    input of the step consuming stream column s+1 (and, for s=0, also the
    BOS column 0 -- position 0 exists on both sides of BOS).
    """
    B, T = cls.shape
    s_pad = tables["accept"].shape[0]
    v0 = jnp.zeros((B, s_pad), DTYPE)
    first0 = jnp.full(B, -1, jnp.int32)

    def body(carry, xs):
        v, first = carry
        cls_t, t = xs
        seed = (starts == t - 1) | ((starts == 0) & (t <= 1))
        v = v.at[:, 0].set(jnp.where(seed & (starts >= 0), 1, v[:, 0]).astype(DTYPE))
        v2 = _step(tables, v, cls_t)
        flag = jnp.dot(v2, tables["accept"], preferred_element_type=jnp.float32) > 0
        e = jnp.clip(t, 0, lengths)
        # only accept ends at/after the start (stale flags impossible since
        # v was empty before the seed, but guard anyway)
        if longest:
            ok = flag & (e >= starts)
        else:
            ok = flag & (e >= starts) & (first < 0)
        first = jnp.where(ok, e, first)
        return (v2, first), None

    (_, first), _ = jax.lax.scan(body, (v0, first0), (cls.T, jnp.arange(T)))
    return first


# ---------------------------------------------------------------------------
# Reverse scan (match starts)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("seed_accept",))
def reverse_hits(
    tables: Tables,
    cls: jnp.ndarray,  # [B, T] int32 stream (same forward layout)
    *,
    seed_accept: bool = True,
) -> jnp.ndarray:
    """Reverse automaton scan. Returns hits [B, T]: hits[:, j] true iff the
    initial state is live just before stream column j, i.e. some match
    starts at position max(j-1, 0).

    Recurrence (mirror of the forward factorization, the capability the
    reference scaffolded but never wired up -- SURVEY.md SS2.10/SS3.3):
        R_j = ((R_{j+1} | accept) & Bc[cls_j]) @ F^T
    """
    B, T = cls.shape
    s_pad = tables["accept"].shape[0]
    c_pad = tables["Bc"].shape[0]
    R0 = jnp.zeros((B, s_pad), DTYPE)
    acc_row = tables["accept"][None, :]

    def body(R, cls_j):
        if seed_accept:
            R = jnp.maximum(R, acc_row.astype(DTYPE))
        oh = (cls_j[:, None] == jnp.arange(c_pad)[None, :]).astype(DTYPE)
        bsel = jnp.dot(oh, tables["Bc"], preferred_element_type=jnp.float32)
        masked = (R > 0) & (bsel > 0)
        Rn = jnp.dot(
            masked.astype(DTYPE), tables["Ft"], preferred_element_type=jnp.float32
        )
        Rn = (Rn > 0).astype(DTYPE)
        hit = Rn[:, 0] > 0
        return Rn, hit

    _, hits_rev = jax.lax.scan(body, R0, cls.T[::-1])
    return hits_rev[::-1].T  # [B, T]


def starts_bitmap(
    hits: jnp.ndarray,  # [B, T]
    lengths: jnp.ndarray,
    max_len: int,
    nullable: bool,
) -> jnp.ndarray:
    """[B, max_len+1] bool: some match starts at position s."""
    B, T = hits.shape
    s = jnp.clip(jnp.arange(T)[None, :] - 1, 0, None)
    s = jnp.minimum(s, lengths[:, None])  # padding cols can't hit, but clamp
    out = jnp.zeros((B, max_len + 1), bool)
    out = out.at[jnp.arange(B)[:, None], s].max(hits)
    if nullable:
        valid = jnp.arange(max_len + 1)[None, :] <= lengths[:, None]
        out = out | valid
    return out


def spans_rounds(hits, lens, end_from, *, cap: int, longest: bool,
                 nullable: bool, max_len: int):
    """Non-overlapping span enumeration as ONE device program, for any
    engine: candidate starts from the reverse scan ``hits`` [B, T]
    (column j: a match starts at max(j - 1, 0)), then a
    ``lax.while_loop`` of anchored rescans ``end_from(starts) -> ends``
    ([B] int32; -1 = none, inactive records pass start -1) — smallest end
    for the lazy policy, largest for greedy. Returns (starts [B, cap],
    ends [B, cap], count [B], overflow [B]): ``count`` is the exact number
    of spans, the first ``cap`` are kept, ``overflow = count > cap``."""
    Bn, T = hits.shape
    lens = jnp.asarray(lens, jnp.int32).reshape(Bn)
    L1 = max_len + 1
    s_of_col = jnp.minimum(jnp.maximum(jnp.arange(T) - 1, 0), max_len)
    sbm = jnp.zeros((Bn, L1), bool)
    sbm = sbm.at[jnp.arange(Bn)[:, None], s_of_col[None, :]].max(hits)
    if nullable:
        sbm = sbm | (jnp.arange(L1)[None, :] <= lens[:, None])
    cols = jnp.arange(L1)[None, :]
    bb = jnp.arange(Bn)
    neg = jnp.full((Bn, cap + 1), -1, jnp.int32)

    def cond(st):
        return jnp.any(st[1])

    def body(st):
        pos, active, sbuf, ebuf, ki = st
        m = sbm & (cols >= pos[:, None]) & (cols <= lens[:, None])
        m = m & active[:, None]
        has = m.any(axis=1)
        s = jnp.where(has, jnp.argmax(m, axis=1), -1).astype(jnp.int32)
        active = active & has
        if nullable and not longest:
            e = s  # lazy end of a nullable pattern is the start
        else:
            e = end_from(s)
            if nullable:
                e = jnp.where(e < s, s, e)  # empty-match fallback
        emit = active & (e >= s)
        kk = jnp.where(emit & (ki < cap), ki, cap)
        sbuf = sbuf.at[bb, kk].set(jnp.where(emit, s, -1))
        ebuf = ebuf.at[bb, kk].set(jnp.where(emit, e, -1))
        pos = jnp.where(emit, jnp.maximum(e, s + 1), pos)
        ki = ki + emit.astype(jnp.int32)
        active = active & emit & (pos <= lens)
        return pos, active, sbuf, ebuf, ki

    _, _, sbuf, ebuf, ki = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.zeros(Bn, jnp.int32),
            jnp.ones(Bn, bool),
            neg,
            neg,
            jnp.zeros(Bn, jnp.int32),
        ),
    )
    return sbuf[:, :cap], ebuf[:, :cap], ki, ki > cap
