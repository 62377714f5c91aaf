"""AST -> Glushkov position NFA (epsilon-free, factorized for the device).

The reference engine builds an epsilon-free *position automaton* by grafting
transition rows during construction (``skip<fwd>``, NFA.cc:108-121; combinators
NFA.cc:122-157). That construction is exactly the classical Glushkov
automaton, which has a property this framework's whole compute path rests on:

    Every transition *into* a position-state ``p`` is labeled by ``p``'s own
    symbol class, so the transition function factorizes

        delta(D, c) = follow(D)  INTERSECT  B[c]

    where ``follow(D) = UNION_{i in D} follow[i]`` is **byte independent** and
    ``B[c] = {p : c in label(p)}`` is a per-symbol state mask.

So the expensive part of the per-byte step (the union over current
states) is a product with a *static* matrix -- a 0/1 matrix product over a
batch of strings, or shift-and-mask words for small automata -- and the
only byte-dependent work is an elementwise AND with one mask row. No
per-lane transition-table gather, which the CPU reference spends all its
time on (``Processor::shift``, NFA.cc:72-102).

Like the reference we run *two passes*: a sizing pass (PseudoNFA analog,
regex.h:78-96) so the tier/padding is known before tables are allocated, then
table construction. State ids are 32-bit (fixing defect SURVEY.md SS2.12.1:
the reference truncates ids to uint8, breaking its own >256-state tier).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import numpy as np

from .parser import BOS, EOS, NSYM, Alt, Concat, Empty, Lit, Node, Repeat, parse

# Hard cap so pathological patterns fail loudly instead of allocating
# gigabyte tables (the block-sparse tier comfortably handles thousands).
MAX_STATES = 16384


class PatternTooLargeError(ValueError):
    pass


# --------------------------------------------------------------------------
# Sizing pass (the NFA<NoStateSet> analog, regex.h:196-205)
# --------------------------------------------------------------------------


def count_positions(node: Node) -> int:
    """Number of Glushkov positions after Repeat expansion (excl. state 0)."""
    if isinstance(node, Empty):
        return 0
    if isinstance(node, Lit):
        return 1
    if isinstance(node, Concat) or isinstance(node, Alt):
        return sum(count_positions(p) for p in node.parts)
    if isinstance(node, Repeat):
        c = count_positions(node.child)
        if node.hi is None:
            # R{m,} = R^max(m,1) with the last copy starred (Parser.cpp:131-132)
            return c * max(node.lo, 1)
        if node.hi == 0:
            return 0
        # R{m,n} = R^m (R?)^(n-m)
        return c * node.hi
    raise TypeError(node)


# --------------------------------------------------------------------------
# Glushkov analysis
# --------------------------------------------------------------------------


@dataclass
class _G:
    """Glushkov attributes of a subexpression."""

    nullable: bool
    first: Set[int]
    last: Set[int]


class _Builder:
    def __init__(self):
        self.labels: List[frozenset] = []  # symbol class per position (1-based)
        self.follow: List[Set[int]] = []  # follow set per position (1-based)

    def new_pos(self, syms: frozenset) -> int:
        self.labels.append(syms)
        self.follow.append(set())
        return len(self.labels)  # positions are 1-based; 0 is the initial state

    def build(self, node: Node) -> _G:
        if isinstance(node, Empty):
            return _G(True, set(), set())
        if isinstance(node, Lit):
            p = self.new_pos(node.syms)
            return _G(False, {p}, {p})
        if isinstance(node, Concat):
            g = self.build(node.parts[0])
            for part in node.parts[1:]:
                h = self.build(part)
                for p in g.last:
                    self.follow[p - 1] |= h.first
                g = _G(
                    g.nullable and h.nullable,
                    g.first | h.first if g.nullable else g.first,
                    h.last | g.last if h.nullable else h.last,
                )
            return g
        if isinstance(node, Alt):
            gs = [self.build(p) for p in node.parts]
            return _G(
                any(g.nullable for g in gs),
                set().union(*(g.first for g in gs)),
                set().union(*(g.last for g in gs)),
            )
        if isinstance(node, Repeat):
            return self._repeat(node)
        raise TypeError(node)

    def _star(self, g: _G) -> _G:
        """Kleene closure: loop last -> first (reference: NFA.cc:150-157)."""
        for p in g.last:
            self.follow[p - 1] |= g.first
        return _G(True, g.first, g.last)

    def _plus(self, g: _G) -> _G:
        """One-or-more: same follow loop as star but nullability unchanged.
        (The reference spends an extra duplicated copy on `aa*`,
        Parser.cpp:116-119; the Glushkov plus needs no duplication.)"""
        for p in g.last:
            self.follow[p - 1] |= g.first
        return g

    def _repeat(self, node: Repeat) -> _G:
        """Expand {m,n} by duplicating the child with fresh positions.

        Mirrors the reference's repeat()/optionalize scheme
        (Parser.cpp:116-141): R{m,} = R^m with the last copy starred,
        R{m,n} = R^m (R?)^{n-m}, R* = star, R? = optional. Duplication is
        what blows ``a{1,300}`` past 256 states onto the sparse tier.
        """
        child, lo, hi = node.child, node.lo, node.hi
        if hi == 0:
            return _G(True, set(), set())
        if hi is None:
            if lo == 0:  # R*
                return self._star(self.build(child))
            # R{m,} = R^{m-1} . R+  (the last copy loops but stays mandatory)
            gs = [self.build(child) for _ in range(lo)]
            gs[-1] = self._plus(gs[-1])
            return self._concat_gs(gs)
        gs = [self.build(child) for _ in range(lo)]
        for _ in range(hi - lo):
            g = self.build(child)
            gs.append(_G(True, g.first, g.last))  # optionalized copy
        return self._concat_gs(gs)

    def _concat_gs(self, gs: List[_G]) -> _G:
        g = gs[0]
        for h in gs[1:]:
            for p in g.last:
                self.follow[p - 1] |= h.first
            g = _G(
                g.nullable and h.nullable,
                g.first | h.first if g.nullable else g.first,
                h.last | g.last if h.nullable else h.last,
            )
        return g


# --------------------------------------------------------------------------
# Compiled (host-side, logical) NFA
# --------------------------------------------------------------------------


@dataclass
class NFA:
    """Logical epsilon-free position NFA.

    State 0 is the initial state; states 1..n_states-1 are Glushkov
    positions. ``follow[i]`` includes state 0's row = first(root).
    Acceptance: D intersects ``accept``; transitions:
    ``delta(D, sym) = (U_{i in D} follow[i]) & B[sym]``.

    The follow relation is stored EITHER as Python sets (``follow_sets``)
    or as an edge array (``edges`` [nnz, 2] int32, the native compiler's
    form); each view materializes lazily from the other. Hot compile paths
    only touch the numpy forms.
    """

    pattern: str
    n_states: int
    labels: List[frozenset]  # per position 1..n-1 (index p-1)
    follow_sets: Optional[List[Set[int]]] = None  # index by state 0..n-1
    accept_set: Set[int] = None
    nullable: bool = False
    edges: Optional[np.ndarray] = None  # [nnz, 2] int32, sorted by source

    def __post_init__(self):
        assert (self.follow_sets is not None) or (self.edges is not None)

    # ---- dense numpy table forms (built lazily) ----
    _follow_mat: Optional[np.ndarray] = None
    _symtab: Optional[np.ndarray] = None
    _accept_vec: Optional[np.ndarray] = None

    def get_follow_sets(self) -> List[Set[int]]:
        """List-of-sets view (materialized on demand from the edge array)."""
        if self.follow_sets is None:
            e = self.edges
            splits = np.searchsorted(e[:, 0], np.arange(1, self.n_states))
            self.follow_sets = [
                set(p.tolist()) for p in np.split(e[:, 1], splits)
            ]
        return self.follow_sets

    def get_edges(self) -> np.ndarray:
        """Edge-array view (materialized on demand from the sets)."""
        if self.edges is None:
            pairs = [
                (i, j)
                for i, fs in enumerate(self.follow_sets)
                for j in sorted(fs)
            ]
            self.edges = np.array(pairs, dtype=np.int32).reshape(-1, 2)
        return self.edges

    @property
    def follow_matrix(self) -> np.ndarray:
        """[S, S] uint8; F[i, j] = 1 iff j in follow(i)."""
        if self._follow_mat is None:
            S = self.n_states
            F = np.zeros((S, S), dtype=np.uint8)
            e = self.get_edges()
            if len(e):
                F[e[:, 0], e[:, 1]] = 1
            self._follow_mat = F
        return self._follow_mat

    @property
    def symtab(self) -> np.ndarray:
        """[NSYM, S] uint8; B[c, p] = 1 iff c in label(p). Column 0 is zero
        (the initial state is never entered)."""
        if self._symtab is None:
            S = self.n_states
            B = np.zeros((NSYM, S), dtype=np.uint8)
            for p, syms in enumerate(self.labels, start=1):
                for c in syms:
                    B[c, p] = 1
            self._symtab = B
        return self._symtab

    @property
    def accept_vec(self) -> np.ndarray:
        if self._accept_vec is None:
            v = np.zeros(self.n_states, dtype=np.uint8)
            for p in self.accept_set:
                v[p] = 1
            self._accept_vec = v
        return self._accept_vec

    # ---- packed integer forms (oracle / word-tier) ----
    def follow_ints(self) -> List[int]:
        return [_set_to_int(fs) for fs in self.get_follow_sets()]

    def symtab_ints(self) -> List[int]:
        out = []
        B = self.symtab
        for c in range(NSYM):
            out.append(_cols_to_int(B[c]))
        return out

    def accept_int(self) -> int:
        return _set_to_int(self.accept_set)

    def dump(self, full: bool = False) -> str:
        """Human-readable NFA dump (the NFA::print analog, NFA.cc:14-41).

        With ``full=True``, also prints the per-state per-symbol forward
        AND backward transition rows (grouped into maximal symbol runs
        with identical targets) — the complete row view NFA::print shows
        for bytes 0..0x7F (NFA.cc:25-40), minus the all-empty rows.
        """
        lines = [
            f"pattern: {self.pattern!r}",
            f"states: {self.n_states} (state 0 = initial)",
            f"accept: {sorted(self.accept_set)}  nullable: {self.nullable}",
        ]
        fs = self.get_follow_sets()
        for i in range(self.n_states):
            lab = "" if i == 0 else f"  label={_fmt_syms(self.labels[i - 1])}"
            lines.append(f"  {i}: follow={sorted(fs[i])}{lab}")
        if not full:
            return "\n".join(lines)

        def sym_name(c: int) -> str:
            if c == BOS:
                return "BOS(^)"
            if c == EOS:
                return "EOS($)"
            return repr(chr(c)) if 32 <= c < 127 else f"\\x{c:02x}"

        def runs_of(row):
            """row: sym -> frozenset targets; yield (lo, hi, targets)."""
            out = []
            for c in range(NSYM):
                t = row.get(c)
                if not t:
                    continue
                if out and out[-1][1] == c - 1 and out[-1][2] == t:
                    out[-1] = (out[-1][0], c, t)
                else:
                    out.append((c, c, t))
            return out

        B = self.symtab  # [NSYM, S]
        lines.append("transition rows (fwd: state -byte-> targets; "
                     "bwd: mirrored predecessor rows):")
        for i in range(self.n_states):
            fwd = {}
            for t in sorted(fs[i]):
                for c in np.nonzero(B[:, t])[0]:
                    fwd.setdefault(int(c), set()).add(t)
            bwd = {}
            if i > 0:
                preds = [s for s in range(self.n_states) if i in fs[s]]
                for c in np.nonzero(B[:, i])[0]:
                    bwd[int(c)] = set(preds)
            row_lines = []
            for lo, hi, t in runs_of(fwd):
                span = sym_name(lo) if lo == hi else f"{sym_name(lo)}-{sym_name(hi)}"
                row_lines.append(f"    fwd {span} -> {sorted(t)}")
            for lo, hi, t in runs_of(bwd):
                span = sym_name(lo) if lo == hi else f"{sym_name(lo)}-{sym_name(hi)}"
                row_lines.append(f"    bwd {span} -> {sorted(t)}")
            if row_lines:
                lines.append(f"  state {i}:")
                lines.extend(row_lines)
        return "\n".join(lines)


def _set_to_int(s: Set[int]) -> int:
    x = 0
    for p in s:
        x |= 1 << p
    return x


def _cols_to_int(col: np.ndarray) -> int:
    x = 0
    for p in np.nonzero(col)[0]:
        x |= 1 << int(p)
    return x


def _fmt_syms(syms: frozenset) -> str:
    names = []
    for c in sorted(syms):
        if c == BOS:
            names.append("^")
        elif c == EOS:
            names.append("$")
        elif 32 <= c < 127:
            names.append(chr(c))
        else:
            names.append(f"\\x{c:02x}")
    if len(names) > 12:
        return f"[{''.join(names[:12])}...{len(names)} syms]"
    return f"[{''.join(names)}]"


def build_nfa(pattern: str, use_native: bool = True) -> NFA:
    """Compile a pattern to its Glushkov NFA (two-pass, like RRegex::RRegex
    Parser.cpp:161-170: size first, then tables).

    Dispatches to the native C++ compiler (native/rrx_host.cc via
    compiler/native.py) when available — identical output, enforced by
    tests/test_native.py — and falls back to the pure-Python build."""
    if use_native:
        from .native import build_nfa_native

        nfa = build_nfa_native(pattern)
        if nfa is not None:
            return nfa
    return build_nfa_py(pattern)


def combine_nfas(nfas: List[NFA]) -> Tuple[NFA, List[Set[int]]]:
    """Union-combine NFAs into one automaton with a shared start state and
    disjoint position ranges — the Glushkov union, scanning P patterns in
    one pass (multi-pattern grep, BASELINE config 5). Returns the combined
    NFA and the per-pattern accept sets in combined state ids (state 0
    belongs to pattern p's accept set iff pattern p is nullable)."""
    n_states = 1 + sum(n.n_states - 1 for n in nfas)
    labels: List[frozenset] = []
    follow_sets: List[Set[int]] = [set()]
    accept_all: Set[int] = set()
    accepts: List[Set[int]] = []
    off = 0
    for n in nfas:
        fs = n.get_follow_sets()
        follow_sets[0] |= {p + off for p in fs[0]}
        for i in range(1, n.n_states):
            follow_sets.append({j + off for j in fs[i]})
        labels.extend(n.labels)
        acc = {p + off if p else 0 for p in n.accept_set}
        accepts.append(acc)
        accept_all |= acc
        off += n.n_states - 1
    combined = NFA(
        pattern="|".join(f"({n.pattern})" for n in nfas),
        n_states=n_states,
        labels=labels,
        follow_sets=follow_sets,
        accept_set=accept_all,
        nullable=any(n.nullable for n in nfas),
    )
    return combined, accepts


def build_nfa_py(pattern: str) -> NFA:
    """Pure-Python reference implementation of the Glushkov build."""
    return build_nfa_ast(parse(pattern), pattern)


def build_nfa_ast(ast, pattern: str) -> NFA:
    """Glushkov build from an already-parsed AST node (used by pattern
    rewrites that compile a sub-expression, e.g. the `.*X.*` long-string
    rewrite in ops/longstring.py). ``pattern`` is only a label."""
    n_pos = count_positions(ast)
    if n_pos + 1 > MAX_STATES:
        raise PatternTooLargeError(
            f"pattern needs {n_pos + 1} states > MAX_STATES={MAX_STATES}"
        )
    b = _Builder()
    g = b.build(ast)
    assert len(b.labels) == n_pos, (len(b.labels), n_pos)
    follow_sets: List[Set[int]] = [set(g.first)] + [set(fs) for fs in b.follow]
    accept = set(g.last)
    if g.nullable:
        accept.add(0)
    return NFA(
        pattern=pattern,
        n_states=n_pos + 1,
        labels=b.labels,
        follow_sets=follow_sets,
        accept_set=accept,
        nullable=g.nullable,
    )
