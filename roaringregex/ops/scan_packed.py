"""Lane-packed scan engine: G records per 128-lane row.

The pure-XLA engine for dense tiers. Key ideas:

* **Lane packing** — a record whose NFA fits in ``s_tile`` states occupies
  ``s_tile`` lanes; ``G = lanes // s_tile`` records share one row. The
  per-byte follow expansion for all G records is ONE matmul with the
  block-diagonal ``F_bd`` — 2*lanes^2/G FLOPs per corpus byte. For a
  7-state pattern like ``cat|dog`` (s_tile=8, G=16) that is 16x fewer
  FLOPs than the unpacked engine (ops/scan_xla.py).

* **Precomputed bit-packed mask stream** — the per-byte symbol mask
  ``B[class]`` is byte-dependent but *position-local*, so it is computed for
  the whole corpus in one embarrassingly-parallel pass (a gather off the
  critical path) and stored bit-packed: ``words[t, row, w]`` holds lanes
  ``32w..32w+31`` of the row's mask at step t — 4 uint32 per row-step
  (8 on dense256), i.e. 16/G bytes per corpus byte. The sequential scan
  then does zero table lookups: unpack bits, one matmul, one AND.

Semantics are identical to ops/scan_xla.py (same stream convention; parity
enforced by tests against the oracle and the unpacked engine).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..compiler.program import DeviceProgram

Tables = Dict[str, jnp.ndarray]

DTYPE = jnp.bfloat16


def stream_tables(prog: DeviceProgram) -> Tables:
    """Byte->mask translation tables (any tier): run ranges + packed words."""
    lo, hi, cl = prog.byte_runs
    run_words = prog.Bc_words[cl] if len(cl) else np.zeros((0, 1), np.uint32)
    return {
        "run_lo": jnp.asarray(lo, jnp.int32),
        "run_hi": jnp.asarray(hi, jnp.int32),
        "run_cls": jnp.asarray(cl, jnp.int32),
        "run_words": jnp.asarray(run_words, jnp.uint32),  # [R, Wt]
        "bos_words": jnp.asarray(prog.Bc_words[prog.bos_class], jnp.uint32),
        "eos_words": jnp.asarray(prog.Bc_words[prog.eos_class], jnp.uint32),
        "byte_class": jnp.asarray(prog.byte_class, jnp.int32),  # [256]
    }


def packed_tables(prog: DeviceProgram) -> Tables:
    assert prog.tier != "sparse", "packed engine covers dense tiers only"
    accept_lanes = (prog.accept_groups.sum(axis=1) > 0).astype(np.uint8)
    seed_groups = np.zeros((prog.lanes, prog.G), dtype=np.uint8)
    for g in range(prog.G):
        seed_groups[g * prog.s_tile, g] = 1
    t = stream_tables(prog)
    t.update({
        "F_bd": jnp.asarray(prog.F_bd, DTYPE),  # [L, L]
        "Ft_bd": jnp.asarray(prog.F_bd.T, DTYPE),  # [L, L]
        "A": jnp.asarray(prog.accept_groups, DTYPE),  # [L, G]
        "accept_lanes": jnp.asarray(accept_lanes, DTYPE),  # [L]
        "seed_row": jnp.asarray(prog.seed_row, DTYPE),  # [L]
        "seed_groups": jnp.asarray(seed_groups, DTYPE),  # [L, G]
        "Bc_words": jnp.asarray(prog.Bc_words, jnp.uint32),  # [c_pad, Wt]
    })
    return t


# ---------------------------------------------------------------------------
# Mask-stream construction (off the critical path, fully parallel)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("s_tile", "G", "n_runs"))
def mask_stream_from_bytes(
    tables: Tables,
    data: jnp.ndarray,  # [B, L] uint8 raw corpus bytes (B = B_rows * G)
    len_g: jnp.ndarray,  # [B_rows, G] int32
    *,
    s_tile: int,
    G: int,
    n_runs: int,
) -> jnp.ndarray:
    """Bytes -> bit-packed mask stream in ONE fused pass, gather-free.

    The byte->class->mask double lookup is replaced by R range-compares
    against the program's byte runs (DeviceProgram.byte_runs): exactly one
    run matches a live byte, dead bytes default to the all-zero mask. Output
    layout: [T, B_rows, W], T = L + 2 (BOS | bytes | EOS/dead tail),
    identical semantics to encode_stream + pack_mask_stream.
    """
    B, L = data.shape
    B_rows = B // G
    lanes = s_tile * G
    W = lanes // 32
    Wt = max(1, s_tile // 32)

    d = data.reshape(B_rows, G, L).transpose(2, 0, 1)  # [L, B_rows, G]
    d = jnp.pad(d, ((0, 1), (0, 0), (0, 0)))  # position L (possible EOS col)
    dd = d[..., None].astype(jnp.int32)  # [L+1, B_rows, G, 1]

    # run-select: tile mask words per position
    tile = jnp.zeros((L + 1, B_rows, G, Wt), jnp.uint32)
    for r in range(n_runs):
        hit = (dd >= tables["run_lo"][r]) & (dd <= tables["run_hi"][r])
        tile = tile | jnp.where(hit, tables["run_words"][r], jnp.uint32(0))

    # boundary overlay: bytes past the record are EOS (at j == len) or dead
    j = jnp.arange(L + 1)[:, None, None, None]
    n = len_g[None, :, :, None]
    tile = jnp.where(
        j < n, tile, jnp.where(j == n, tables["eos_words"], jnp.uint32(0))
    )

    body = _pack_groups(tile, s_tile, G, W)  # [L+1, B_rows, W]
    bos_tile = jnp.broadcast_to(
        tables["bos_words"], (1, B_rows, G, Wt)
    )
    bos = _pack_groups(bos_tile, s_tile, G, W)  # [1, B_rows, W]
    return jnp.concatenate([bos, body], axis=0)  # [T, B_rows, W]


def _pack_groups(tile: jnp.ndarray, s_tile: int, G: int, W: int) -> jnp.ndarray:
    """[T', B_rows, G, Wt] tile words -> [T', B_rows, W] full-row words."""
    Tp, B_rows = tile.shape[:2]
    if s_tile >= 32:
        return tile.reshape(Tp, B_rows, W)
    k = 32 // s_tile  # tiles per 32-bit word
    shifts = (jnp.arange(k, dtype=jnp.uint32) * s_tile)[None, None, None, :]
    t = tile.reshape(Tp, B_rows, W, k)
    return jnp.sum((t << shifts).astype(jnp.uint32), axis=3, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnames=("s_tile", "G"))
def pack_mask_stream(
    tables: Tables,
    cls: jnp.ndarray,  # [B, T] int32 class stream (B = B_rows * G)
    *,
    s_tile: int,
    G: int,
) -> jnp.ndarray:
    """[T, B_rows, W] uint32 bit-packed per-step symbol masks, lane order
    lane = 32*w + bit; record g occupies lanes [g*s_tile, (g+1)*s_tile)."""
    B, T = cls.shape
    assert B % G == 0, (B, G)
    B_rows = B // G
    lanes = s_tile * G
    W = lanes // 32
    tw = jnp.take(tables["Bc_words"], cls, axis=0)  # [B, T, Wt] uint32
    tw = tw.reshape(B_rows, G, T, -1)
    if s_tile >= 32:
        # group g's Wt words lie at words [g*Wt, (g+1)*Wt)
        words = tw.transpose(2, 0, 1, 3).reshape(T, B_rows, W)
    else:
        # k tiles per 32-bit word; tile m within a word shifts by m*s_tile
        k = 32 // s_tile
        shifts = (jnp.arange(k, dtype=jnp.uint32) * s_tile)[None, None, :, None]
        tw = tw.reshape(B_rows, W, k, T)  # [rows, word, tile-in-word, T]
        words = jnp.sum(
            (tw << shifts).astype(jnp.uint32), axis=2, dtype=jnp.uint32
        )  # disjoint bit ranges -> sum == OR
        words = words.transpose(2, 0, 1)  # [T, B_rows, W]
    return words


def unpack_bits(words: jnp.ndarray, lanes: int) -> jnp.ndarray:
    """[.., W] uint32 -> [.., lanes] bool."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[..., None] >> shifts) & jnp.uint32(1)
    return (bits > 0).reshape(*words.shape[:-1], lanes)


# ---------------------------------------------------------------------------
# Forward scan
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("seeded", "nullable", "n_seed_steps", "lanes", "lead"),
)
def match_stats(
    tables: Tables,
    words: jnp.ndarray,  # [T, B_rows, W] uint32 mask stream
    len_g: jnp.ndarray,  # [B_rows, G] int32 record lengths
    *,
    seeded: bool,
    nullable: bool,
    lanes: int,
    n_seed_steps: int = 2,
    lead: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(count, first_end, any) per record, each [B_rows, G] — the packed
    analog of scan_xla.match_stats (identical counting semantics).
    ``lead``: accepts at steps <= lead are ignored (overlapped windows:
    those ends belong to the previous window)."""
    T, B_rows, W = words.shape
    G = len_g.shape[1]
    v0 = jnp.broadcast_to(tables["seed_row"], (B_rows, lanes)).astype(DTYPE)
    cnt0 = jnp.zeros((B_rows, G), jnp.int32)
    first0 = jnp.full((B_rows, G), -1, jnp.int32)
    last0 = jnp.full((B_rows, G), -1, jnp.int32)
    if nullable:
        cnt0 = (len_g + 1) if seeded else (cnt0 + 1)
        first0 = jnp.zeros((B_rows, G), jnp.int32)
        last0 = len_g if seeded else jnp.zeros((B_rows, G), jnp.int32)

    seed = tables["seed_row"]

    def body(carry, xs):
        v, cnt, first, last = carry
        words_t, t = xs
        gate = jnp.asarray(seeded) | (t < n_seed_steps)
        v = jnp.where(gate, jnp.maximum(v, seed), v)
        y = jnp.dot(v, tables["F_bd"], preferred_element_type=jnp.float32)
        bits = unpack_bits(words_t, lanes)
        v2 = ((y > 0) & bits).astype(DTYPE)
        flag = (
            jnp.dot(v2, tables["A"], preferred_element_type=jnp.float32) > 0
        )  # [B_rows, G]
        if lead:
            flag = flag & (t > lead)
        e = jnp.clip(t, 0, len_g)
        if nullable and seeded:
            new = jnp.zeros_like(flag)
        else:
            new = flag & (e != last)
        cnt = cnt + new.astype(jnp.int32)
        first = jnp.where((first < 0) & flag, e, first)
        last = jnp.where(flag, e, last)
        return (v2, cnt, first, last), None

    (v, cnt, first, last), _ = jax.lax.scan(
        body, (v0, cnt0, first0, last0), (words, jnp.arange(T))
    )
    return cnt, first, cnt > 0


@functools.partial(jax.jit, static_argnames=("seeded", "n_seed_steps", "lanes"))
def forward_flags(
    tables: Tables,
    words: jnp.ndarray,  # [T, B_rows, W]
    *,
    seeded: bool,
    lanes: int,
    n_seed_steps: int = 2,
) -> jnp.ndarray:
    """[B, T+1] accept flags (B = B_rows*G, record r = row*G + g)."""
    T, B_rows, W = words.shape
    G = tables["A"].shape[1]
    v0 = jnp.broadcast_to(tables["seed_row"], (B_rows, lanes)).astype(DTYPE)
    seed = tables["seed_row"]

    def body(v, xs):
        words_t, t = xs
        gate = jnp.asarray(seeded) | (t < n_seed_steps)
        v = jnp.where(gate, jnp.maximum(v, seed), v)
        y = jnp.dot(v, tables["F_bd"], preferred_element_type=jnp.float32)
        v2 = ((y > 0) & unpack_bits(words_t, lanes)).astype(DTYPE)
        flag = jnp.dot(v2, tables["A"], preferred_element_type=jnp.float32) > 0
        return v2, flag

    _, flags = jax.lax.scan(body, v0, (words, jnp.arange(T)))  # [T, B_rows, G]
    B = B_rows * G
    flags = flags.transpose(1, 2, 0).reshape(B, T)
    # accept-before-any-step: nullable-iff initial lane accepting (state 0)
    flag0 = jnp.broadcast_to(
        jnp.dot(
            tables["seed_row"], tables["accept_lanes"],
            preferred_element_type=jnp.float32,
        ) > 0,
        (B, 1),
    )
    return jnp.concatenate([flag0, flags], axis=1)  # [B, T+1]


# ---------------------------------------------------------------------------
# Reverse scan (match starts)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("lanes",))
def reverse_hits(
    tables: Tables,
    words: jnp.ndarray,  # [T, B_rows, W]
    *,
    lanes: int,
) -> jnp.ndarray:
    """[B, T] — hits[:, j] true iff some match starts at position
    max(j-1, 0) (packed analog of scan_xla.reverse_hits)."""
    T, B_rows, W = words.shape
    G = tables["A"].shape[1]
    R0 = jnp.zeros((B_rows, lanes), DTYPE)
    acc = tables["accept_lanes"][None, :].astype(DTYPE)

    def body(R, words_j):
        R = jnp.maximum(R, acc)
        masked = ((R > 0) & unpack_bits(words_j, lanes)).astype(DTYPE)
        Rn = jnp.dot(masked, tables["Ft_bd"], preferred_element_type=jnp.float32)
        Rn = (Rn > 0).astype(DTYPE)
        hit = (
            jnp.dot(Rn, tables["seed_groups"], preferred_element_type=jnp.float32)
            > 0
        )  # [B_rows, G]
        return Rn, hit

    _, hits_rev = jax.lax.scan(body, R0, words[::-1])
    hits = hits_rev[::-1]  # [T, B_rows, G]
    return hits.transpose(1, 2, 0).reshape(B_rows * G, T)


@functools.partial(jax.jit, static_argnames=("lanes", "s_tile", "longest"))
def first_end_from(
    tables: Tables,
    words: jnp.ndarray,  # [T, B_rows, W] mask stream
    len_g: jnp.ndarray,  # [B_rows, G]
    starts_g: jnp.ndarray,  # [B_rows, G] per-record match start; -1 inactive
    *,
    lanes: int,
    s_tile: int,
    longest: bool = False,
) -> jnp.ndarray:
    """Smallest (lazy) or largest (``longest=True``, greedy leftmost-longest)
    end e with text[s:e] matching, per record (packed analog of
    scan_xla.first_end_from; the anchored rescan of span extraction)."""
    T, B_rows, W = words.shape
    G = len_g.shape[1]
    v0 = jnp.zeros((B_rows, lanes), DTYPE)
    first0 = jnp.full((B_rows, G), -1, jnp.int32)
    seed = tables["seed_row"]

    def body(carry, xs):
        v, first = carry
        words_t, t = xs
        gate = ((starts_g == t - 1) | ((starts_g == 0) & (t <= 1))) & (
            starts_g >= 0
        )  # [B_rows, G]
        gl = jnp.repeat(gate, s_tile, axis=1).astype(DTYPE)  # [B_rows, lanes]
        v = jnp.maximum(v, gl * seed[None, :])
        y = jnp.dot(v, tables["F_bd"], preferred_element_type=jnp.float32)
        v2 = ((y > 0) & unpack_bits(words_t, lanes)).astype(DTYPE)
        fl = jnp.dot(v2, tables["A"], preferred_element_type=jnp.float32) > 0
        e = jnp.clip(t, 0, len_g)
        if longest:
            ok = fl & (e >= starts_g)
        else:
            ok = fl & (e >= starts_g) & (first < 0)
        first = jnp.where(ok, e, first)
        return (v2, first), None

    (_, first), _ = jax.lax.scan(body, (v0, first0), (words, jnp.arange(T)))
    return first
