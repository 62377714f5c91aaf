"""Device program format: padded, tiered, alphabet-compressed NFA tables.

This is the L1 "compiled program" layer (SURVEY.md SS7.1): the bridge between
the host compiler (Glushkov NFA) and the device scan kernels. Design:

Tiers (the device analog of the reference's u64 / SSE / AVX2 / Roaring
state-set tiers, Parser.cpp:165-168):

* ``dense128``  -- S <= 128 states, tables padded to 128.
* ``dense256``  -- S <= 256 states, padded to 256.
* ``multiblock`` -- 256 < S <= 1024: dense tables over ceil(S/128)*128
  lanes; the follow matmul spans several 128-blocks but the scan code is
  unchanged (lanes-parametric).
* ``sparse``    -- S > 1024: the *follow matrix* is stored block-sparse as
  (block_row, block_col, 128x128 block) triples. This is the roaring idea
  translated to XLA: instead of compressing the state *set* (dynamic shapes,
  which XLA cannot tile), we compress the static transition *structure*,
  which for repetition-blowup patterns like ``a{1,300}`` is a banded matrix
  with O(S/128) nonzero blocks instead of O((S/128)^2).

Alphabet compression: bytes with identical symbol-mask rows are merged into
equivalence classes (classic DFA technique; typical patterns have < 16
classes). The corpus is translated bytes->classes once, off the hot loop, so
the per-step symbol mask lookup inside the kernel contracts over ``c_pad``
(~32) lanes instead of 256.

The per-step transition is one fused matmul (see ops/): with
``M = [[F], [K * Bc]]`` and ``u = [v | onehot(class)]``,

    acc = u @ M = (v @ F) + K * B[class];     v' = acc > K

because ``v @ F <= S < K`` -- a single matrix product computes both the
follow expansion and the symbol mask.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .nfa import NFA, build_nfa
from .parser import BOS, EOS, NSYM

BLOCK = 128  # block edge of the tiled tables

# Lane-packing tile sizes: a record's NFA states occupy ``s_tile`` lanes and
# G = lanes // s_tile records share one 128-lane (256 for dense256) row.
# This is the packed analog of the reference's *small* tiers (u64 BitSet<1>
# for <=64 states, Parser.cpp:165-168): instead of shrinking the register,
# we pack multiple records' state masks into one row so the per-byte follow
# matmul costs 2*128*128/G FLOPs per corpus byte instead of 2*128*128.
TILES = (8, 16, 32, 64, 128, 256, 384, 512, 640, 768, 896, 1024)

# Default largest state count with fully dense device tables; past this the
# block-sparse tier takes over (the CRoaring-tier analog, SURVEY.md SS2.2).
# Overridable via RrxConfig.dense_max / RRX_DENSE_MAX.
DENSE_MAX = 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class DeviceProgram:
    """Host-side container of device-ready tables (numpy; engines move them
    to device and cast to their compute dtype)."""

    nfa: NFA
    tier: str
    s_pad: int
    # alphabet compression
    n_classes: int
    c_pad: int
    class_of_sym: np.ndarray  # [NSYM + 1] int32; index NSYM = dead symbol
    byte_class: np.ndarray  # [256] int32 lookup for raw corpus bytes
    # dense tables, 0/1 uint8, padded to (s_pad, c_pad)
    F: Optional[np.ndarray]  # [s_pad, s_pad]; None on the sparse tier
    Bc: np.ndarray  # [c_pad, s_pad]
    accept: np.ndarray  # [s_pad]
    # block-sparse follow layout (always available; primary on 'sparse')
    fblocks: np.ndarray = field(default=None)  # [nnz, BLOCK, BLOCK] uint8
    fblock_rows: np.ndarray = field(default=None)  # [nnz] int32
    fblock_cols: np.ndarray = field(default=None)  # [nnz] int32
    # ---- lane-packed layout (dense tiers only) ----
    s_tile: int = 0  # states per record tile (8..256)
    lanes: int = 0  # row width: 128, or 256 on dense256
    G: int = 0  # records packed per row = lanes // s_tile

    # ------------------------------------------------------------------
    # Packed-tier derived tables (built lazily; None on the sparse tier)
    # ------------------------------------------------------------------
    @property
    def F_bd(self) -> Optional[np.ndarray]:
        """[lanes, lanes] uint8 block-diagonal follow matrix: G copies of
        the s_tile x s_tile tile, so one matmul advances G records."""
        if self.tier == "sparse":
            return None
        if getattr(self, "_F_bd", None) is None:
            Ft = self.F[: self.s_tile, : self.s_tile]
            bd = np.zeros((self.lanes, self.lanes), dtype=np.uint8)
            for g in range(self.G):
                o = g * self.s_tile
                bd[o : o + self.s_tile, o : o + self.s_tile] = Ft
            self._F_bd = bd
        return self._F_bd

    @property
    def Bc_words(self) -> Optional[np.ndarray]:
        """[c_pad, W_tile] uint32: per-class symbol mask of one tile,
        bit-packed in lane order (W_tile = ceil(s_tile/32), min 1)."""
        if getattr(self, "_Bc_words", None) is None:
            wt = max(1, self.s_tile // 32)
            out = np.zeros((self.c_pad, wt), dtype=np.uint64)
            Bt = self.Bc[:, : self.s_tile]
            for k in range(self.c_pad):
                for s in np.nonzero(Bt[k])[0]:
                    out[k, s // 32] |= np.uint64(1) << np.uint64(s % 32)
            self._Bc_words = out.astype(np.uint32)
        return self._Bc_words

    @property
    def accept_groups(self) -> Optional[np.ndarray]:
        """[lanes, G] uint8: A[l, g] = 1 iff lane l is an accepting state of
        the record in group g (so per-record flags = (v @ A) > 0)."""
        if getattr(self, "_A", None) is None:
            A = np.zeros((self.lanes, self.G), dtype=np.uint8)
            at = self.accept[: self.s_tile]
            for g in range(self.G):
                o = g * self.s_tile
                A[o : o + self.s_tile, g] = at
            self._A = A
        return self._A

    @property
    def seed_row(self) -> Optional[np.ndarray]:
        """[lanes] uint8: 1 at each record's initial-state lane (g*s_tile)."""
        if getattr(self, "_seed", None) is None:
            s = np.zeros(self.lanes, dtype=np.uint8)
            s[:: self.s_tile] = 1
            self._seed = s
        return self._seed

    @property
    def pattern(self) -> str:
        return self.nfa.pattern

    @property
    def uses_anchor(self) -> bool:
        """True iff the pattern contains ``^``/``$`` (some position is
        labeled with the BOS/EOS pseudo-symbol). Anchor-free programs may
        inject BOS/EOS steps at arbitrary stream offsets (both symbols are
        inert: no position's label matches them), which the windowed batch
        fast path (engine._window_plan) relies on."""
        if getattr(self, "_uses_anchor", None) is None:
            from .parser import BOS, EOS

            B = self.nfa.symtab
            self._uses_anchor = bool(B[BOS].any() or B[EOS].any())
        return self._uses_anchor

    @property
    def horizon(self) -> Optional[int]:
        """Longest path length in the follow graph, or None if cyclic.

        When finite, the automaton's state d steps after any stream
        position depends only on the last ``horizon`` stream steps plus
        seed injections: every active position is the endpoint of a
        follow path from a start, and all paths have length <= horizon.
        This bounds match length AND the influence of a block's entry
        frontier, enabling the exact overlapped long-string fast path
        (ops/longstring.py) that scans overlapping slices at full batch
        rate instead of carrying per-block summary bases."""
        if getattr(self, "_horizon", None) is None:
            S = self.n_states
            fm = self.nfa.follow_matrix
            adj = [np.nonzero(fm[s][:S])[0] for s in range(S)]
            color = np.zeros(S, np.int8)  # 0 new, 1 on stack, 2 done
            depth = np.zeros(S, np.int64)
            cyclic = False
            for root in range(S):
                if color[root]:
                    continue
                stack = [(root, 0)]
                while stack:
                    u, it = stack[-1]
                    if it == 0:
                        color[u] = 1
                    nxt = adj[u]
                    if it < len(nxt):
                        stack[-1] = (u, it + 1)
                        v = int(nxt[it])
                        if color[v] == 1:
                            cyclic = True
                            stack.clear()
                            break
                        if color[v] == 0:
                            stack.append((v, 0))
                        else:
                            depth[u] = max(depth[u], depth[v] + 1)
                    else:
                        color[u] = 2
                        stack.pop()
                        if stack:
                            p = stack[-1][0]
                            depth[p] = max(depth[p], depth[u] + 1)
                if cyclic:
                    break
            self._horizon = (-1 if cyclic else int(depth.max(initial=0)))
        return None if self._horizon < 0 else self._horizon

    @property
    def n_states(self) -> int:
        return self.nfa.n_states

    @property
    def nullable(self) -> bool:
        return self.nfa.nullable

    @property
    def bos_class(self) -> int:
        return int(self.class_of_sym[BOS])

    @property
    def eos_class(self) -> int:
        return int(self.class_of_sym[EOS])

    @property
    def dead_class(self) -> int:
        return int(self.class_of_sym[NSYM])

    @property
    def byte_runs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Maximal constant runs of the byte->class LUT with nonzero class:
        (lo[R], hi[R], cls[R]) uint8/int32. Class 0 is the dead/zero-mask
        class, so bytes outside every run default to 0 — this turns the
        byte->class translation into R range-compares instead of a 256-entry
        gather, fused into the scan's byte loads."""
        if getattr(self, "_runs", None) is None:
            bc = self.byte_class
            lo, hi, cl = [], [], []
            r = 0
            while r < 256:
                c = bc[r]
                e = r
                while e + 1 < 256 and bc[e + 1] == c:
                    e += 1
                if c != 0:
                    lo.append(r)
                    hi.append(e)
                    cl.append(int(c))
                r = e + 1
            self._runs = (
                np.asarray(lo, np.int32),
                np.asarray(hi, np.int32),
                np.asarray(cl, np.int32),
            )
        return self._runs

    # ------------------------------------------------------------------
    def classes_of_bytes(self, data: np.ndarray) -> np.ndarray:
        """Translate raw uint8 corpus bytes to class ids (host-side numpy;
        engines have a vectorized on-device version)."""
        return self.byte_class[data.astype(np.int64)]


def compile_program(pattern_or_nfa) -> DeviceProgram:
    nfa = (
        pattern_or_nfa
        if isinstance(pattern_or_nfa, NFA)
        else build_nfa(pattern_or_nfa)
    )
    S = nfa.n_states

    # ---- tier selection (reference analog: Parser.cpp:165-168) ----
    from ..utils.config import get_config

    dense_max = min(get_config().dense_max, max(TILES))
    if S <= BLOCK:
        tier, s_pad = "dense128", BLOCK
    elif S <= 2 * BLOCK:
        tier, s_pad = "dense256", 2 * BLOCK
    elif S <= dense_max:
        tier, s_pad = "multiblock", _round_up(S, BLOCK)
    else:
        tier, s_pad = "sparse", _round_up(S, BLOCK)

    # lane-packing tile: smallest tile holding all states
    if tier == "sparse":
        s_tile, lanes, G = s_pad, s_pad, 1
    else:
        s_tile = next(t for t in TILES if S <= t)
        lanes = max(s_pad, BLOCK)
        G = lanes // s_tile

    # ---- alphabet equivalence classes ----
    # Symbols 0..NSYM-1 plus a dead symbol (bytes >= 0x80, padding).
    B = nfa.symtab  # [NSYM, S] uint8
    rows: Dict[bytes, int] = {}
    class_of_sym = np.zeros(NSYM + 1, dtype=np.int32)
    class_rows: List[np.ndarray] = []
    zero_row = np.zeros(S, dtype=np.uint8)

    def _class_id(row: np.ndarray) -> int:
        key = row.tobytes()
        if key not in rows:
            rows[key] = len(class_rows)
            class_rows.append(row)
        return rows[key]

    _class_id(zero_row)  # class 0 = dead (also BOS/EOS when unused)
    for sym in range(NSYM):
        class_of_sym[sym] = _class_id(B[sym])
    class_of_sym[NSYM] = 0

    n_classes = len(class_rows)
    c_pad = max(32, _round_up(n_classes, 32))

    byte_class = np.zeros(256, dtype=np.int32)
    byte_class[:128] = class_of_sym[:128]
    byte_class[128:] = 0  # dead

    # ---- padded dense tables ----
    Bc = np.zeros((c_pad, s_pad), dtype=np.uint8)
    for k, row in enumerate(class_rows):
        Bc[k, :S] = row
    accept = np.zeros(s_pad, dtype=np.uint8)
    accept[:S] = nfa.accept_vec

    F = None
    fblocks = fb_rows = fb_cols = None
    if tier != "sparse":
        F = np.zeros((s_pad, s_pad), dtype=np.uint8)
        F[:S, :S] = nfa.follow_matrix
    else:
        fblocks, fb_rows, fb_cols = _block_sparse_follow(nfa, s_pad)

    return DeviceProgram(
        nfa=nfa,
        tier=tier,
        s_pad=s_pad,
        n_classes=n_classes,
        c_pad=c_pad,
        class_of_sym=class_of_sym,
        byte_class=byte_class,
        F=F,
        Bc=Bc,
        accept=accept,
        fblocks=fblocks,
        fblock_rows=fb_rows,
        fblock_cols=fb_cols,
        s_tile=s_tile,
        lanes=lanes,
        G=G,
    )


def _block_sparse_follow(
    nfa: NFA, s_pad: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the block-sparse follow layout without materializing the dense
    S x S matrix (S can be thousands; density is what broke the reference's
    roaring tier conceptually -- SS2.12.1)."""
    nb = s_pad // BLOCK
    e = nfa.get_edges()
    if len(e) == 0:
        # degenerate (e.g. pattern ''); keep one zero block for static shapes
        return (
            np.zeros((1, BLOCK, BLOCK), np.uint8),
            np.zeros(1, np.int32),
            np.zeros(1, np.int32),
        )
    key = (e[:, 0] // BLOCK).astype(np.int64) * nb + e[:, 1] // BLOCK
    order = np.argsort(key, kind="stable")
    es, ks = e[order], key[order]
    uniq, starts = np.unique(ks, return_index=True)
    bounds = np.append(starts, len(es))
    fblocks = np.zeros((len(uniq), BLOCK, BLOCK), dtype=np.uint8)
    for n in range(len(uniq)):
        sub = es[bounds[n] : bounds[n + 1]]
        fblocks[n, sub[:, 0] % BLOCK, sub[:, 1] % BLOCK] = 1
    rows = (uniq // nb).astype(np.int32)
    cols = (uniq % nb).astype(np.int32)
    assert rows.max() < nb and cols.max() < nb
    return fblocks, rows, cols
