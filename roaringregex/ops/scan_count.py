"""Run-length (counting) tier: fixed-length-body ``X{m,n}`` as one int32.

``X{m,n}`` where X is a sequence of symbol classes (``a{3,1200}``,
``(ab){2,600}``) or an alternation of equal-length such sequences
(``(ab|cd){1,400}``) has a Glushkov follow matrix that is a dense triangle
(every copy past the m-th is optional, so each position follows all
earlier ones): the matrix tiers pay a lanes^2 product per byte for it —
the family the reference's Roaring tier exists for (Parser.cpp:165-168,
regex.h:34). Because every body copy has fixed length k, the reachable
state sets are suffix intervals and the subset simulation collapses to
one integer per record: the number of consecutive body copies ending at
the cursor (a run-length recurrence at stride k), accept iff run >= m.
Body occurrence is tracked with R*(k-1) rolling per-branch prefix bits.

The recurrence is the body of a ``lax.scan`` over time-major bytes that
carries one run counter per record (plus the k-deep lag buffer); the
collapse from S states to one int32 is algorithmic, so it pays on any
hardware. Stream convention as ops/scan_xla.py: step t consumes byte t-1
for 1 <= t <= len, the end of step t is min(t, len).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..compiler.program import DeviceProgram


def counting_plan(prog: DeviceProgram):
    """Detect ``X{m,n}`` with a fixed-length body and return the
    run-length plan ``(m, n_or_0, branches)``: branches is a tuple of
    R <= 4 branch bodies, each a tuple of per-position byte-run tuples,
    all the same length k <= 8. None when the pattern has another shape.

    (For X{m,n} with a fixed-length body, any chain of r >= m consecutive
    copies ending at e contains a min(r, n)-copy suffix chain, so the n
    bound never changes the seeded ends set — only the anchored/unseeded
    gates use it.)"""
    from ..compiler.parser import BOS, EOS, Alt, Concat, Lit, Repeat, parse

    try:
        node = parse(prog.pattern)
    except Exception:
        return None
    while isinstance(node, Concat) and len(node.parts) == 1:
        node = node.parts[0]
    if not isinstance(node, Repeat):
        return None
    child = node.child
    while isinstance(child, Concat) and len(child.parts) == 1:
        child = child.parts[0]
    alts = list(child.parts) if isinstance(child, Alt) else [child]
    if not 1 <= len(alts) <= 4:
        return None

    def branch_body(b):
        while isinstance(b, Concat) and len(b.parts) == 1:
            b = b.parts[0]
        parts = list(b.parts) if isinstance(b, Concat) else [b]
        if not 1 <= len(parts) <= 8:
            return None
        body = []
        for p in parts:
            while isinstance(p, Concat) and len(p.parts) == 1:
                p = p.parts[0]
            if not isinstance(p, Lit):
                return None
            syms = p.syms
            if BOS in syms or EOS in syms:
                return None
            bs = sorted(syms)
            runs = []
            lo = prev = bs[0]
            for b2 in bs[1:]:
                if b2 == prev + 1:
                    prev = b2
                else:
                    runs.append((lo, prev))
                    lo = prev = b2
            runs.append((lo, prev))
            body.append(tuple(runs))
        return tuple(body)

    branches = []
    for a in alts:
        bb = branch_body(a)
        if bb is None:
            return None
        branches.append(bb)
    k = len(branches[0])
    if any(len(b) != k for b in branches[1:]):
        return None  # unequal branch lengths: stride-k chain breaks
    branches = tuple(dict.fromkeys(branches))  # dedup identical branches
    if k == 1:
        # single-position branches are one merged class (OR of runs)
        branches = ((tuple(r for b in branches for r in b[0]),),)
    n = 0 if node.hi is None else int(node.hi)
    return int(node.lo), n, branches


def _in_class(d, runs):
    x = None
    for lo, hi in runs:
        t = (d >= lo) & (d <= hi)
        x = t if x is None else (x | t)
    return x


class CountScanner:
    """Run-length scanner for fixed-length-body ``X{m,n}`` (see
    counting_plan). Serves match statistics, flags and start hits;
    anchored rescans and spans stay on the packed/XLA engines."""

    def __init__(self, prog: DeviceProgram, plan, nullable=None):
        self.prog = prog
        self.m, self.n, self.body = plan  # body = R branch bodies
        self.k = len(self.body[0])
        self.R = len(self.body)
        self.nullable = prog.nullable if nullable is None else nullable

    # -- the recurrence -----------------------------------------------------
    def _hits(self, d, valid):
        return [
            [_in_class(d, br[q]) & valid for q in range(self.k)]
            for br in self.body
        ]

    def _forward(self, data, lens, seeded: bool):
        """Per-step accept flags [T, B] (T = L + 2) of the forward
        recurrence: seeded (any start) or unseeded (anchored at 0)."""
        k, R = self.k, self.R
        mm = max(self.m, 1)
        n = self.n
        cap = n if n else mm
        B, L = data.shape
        T = L + 2
        dT = jnp.pad(data, ((0, 0), (1, 1))).T.astype(jnp.int32)  # [T, B]
        zi = jnp.zeros((B,), jnp.int32)
        zb = jnp.zeros((B,), bool)

        def step(carry, xs):
            rb, ab, pb = carry  # k run lags, k anchored lags, R*(k-1) bits
            d, tg = xs
            valid = (tg >= 1) & (tg <= lens)
            hits = self._hits(d, valid)
            if k == 1:
                occ = hits[0][0]
                for br in range(1, R):
                    occ = occ | hits[br][0]
                new_pb = pb
            else:
                occ = None
                new_pb = []
                for br in range(R):
                    p = pb[br * (k - 1) : (br + 1) * (k - 1)]
                    o = p[k - 2] & hits[br][k - 1]
                    occ = o if occ is None else (occ | o)
                    new_pb.append(hits[br][0])
                    for q in range(2, k):
                        new_pb.append(p[q - 2] & hits[br][q - 1])
                new_pb = tuple(new_pb)
            r = jnp.where(occ, jnp.minimum(rb[0] + 1, cap), 0)
            rb = rb[1:] + (r,)
            if seeded:
                fl = r >= mm
            else:
                ap = jnp.where(tg < 1, True, occ & ab[0])
                if k == 1:
                    # dead tail passes through (the matrix tiers' frozen
                    # post-EOS state; values past lens are never read)
                    ap = jnp.where(tg > lens, ab[0], ap)
                ab = ab[1:] + (ap,)
                fl = ap & (tg >= mm * k) & (tg <= lens)
                if k > 1:
                    fl = fl & (tg % k == 0)
                if n:
                    fl = fl & (tg <= n * k)
            return (rb, ab, new_pb), fl

        init = (
            (zi,) * k,
            (~zb,) * k,
            (zb,) * max(R * (k - 1), 0),
        )
        _, fls = jax.lax.scan(
            step, init, (dT, jnp.arange(T, dtype=jnp.int32))
        )
        return fls

    # -- match stats -------------------------------------------------------
    def match_stats_b(self, data, len_g, *, seeded: bool, lead: int = 0):
        """(cnt, first, last, full, any), each [B, 1]; ``lead``: accepts
        at steps <= lead are ignored (overlapped windows)."""
        lens = jnp.asarray(len_g).reshape(-1).astype(jnp.int32)
        out = self._stats(jnp.asarray(data), lens, seeded=seeded, lead=lead)
        return tuple(x.reshape(-1, 1) for x in out)

    @functools.partial(jax.jit, static_argnames=("self", "seeded", "lead"))
    def _stats(self, data, lens, *, seeded: bool, lead: int):
        fls = self._forward(data, lens, seeded)  # [T, B]
        T = fls.shape[0]
        tg = jnp.arange(T, dtype=jnp.int32)[:, None]
        if lead:
            fls = fls & (tg > lead)
        # every accepting step has 1 <= t <= len, so its end e = t is new
        e = jnp.minimum(tg, lens[None, :])
        nflags = jnp.sum(fls.astype(jnp.int32), axis=0)
        big = jnp.int32(1 << 30)
        fe = jnp.min(jnp.where(fls, e, big), axis=0)
        le = jnp.max(jnp.where(fls, e, -1), axis=0)
        full = jnp.any(fls & (tg >= lens[None, :]), axis=0)
        if self.nullable:
            full = full | (lens == 0)
            first = jnp.zeros_like(lens)
            if seeded:
                cnt = lens + 1
                last = jnp.where(le >= 0, le, lens)
            else:
                cnt = 1 + nflags
                last = jnp.where(le >= 0, le, 0)
        else:
            cnt = nflags
            first = jnp.where(fe >= big, -1, fe)
            last = le
        return cnt, first, last, full, cnt > 0

    # -- forward flags -----------------------------------------------------
    def forward_flags_b(self, data, len_g, *, seeded: bool):
        """[B, T + 1] accept flags (column 0: before any step)."""
        lens = jnp.asarray(len_g).reshape(-1).astype(jnp.int32)
        return self._flags(jnp.asarray(data), lens, seeded=seeded)

    @functools.partial(jax.jit, static_argnames=("self", "seeded"))
    def _flags(self, data, lens, *, seeded: bool):
        fl = self._forward(data, lens, seeded).T  # [B, T]
        flag0 = jnp.full((fl.shape[0], 1), bool(self.prog.nullable), bool)
        return jnp.concatenate([flag0, fl], axis=1)

    # -- reverse hits ------------------------------------------------------
    def reverse_hits_b(self, data, len_g):
        """[B, T] bool: a run of >= m body copies starts at step t's byte
        (match-start candidates; start position max(t - 1, 0))."""
        lens = jnp.asarray(len_g).reshape(-1).astype(jnp.int32)
        return self._reverse(jnp.asarray(data), lens)

    @functools.partial(jax.jit, static_argnames=("self",))
    def _reverse(self, data, lens):
        k, R = self.k, self.R
        mm = max(self.m, 1)
        B, L = data.shape
        T = L + 2
        dT = jnp.pad(data, ((0, 0), (1, 1))).T.astype(jnp.int32)
        zi = jnp.zeros((B,), jnp.int32)
        zb = jnp.zeros((B,), bool)

        def step(carry, xs):
            rb, pb = carry  # rb: r(t+1) .. r(t+k), newest first
            d, tg = xs
            valid = (tg >= 1) & (tg <= lens)
            hits = self._hits(d, valid)
            if k == 1:
                occ = hits[0][0]
                for br in range(1, R):
                    occ = occ | hits[br][0]
                new_pb = pb
            else:
                occ = None
                new_pb = []
                for br in range(R):
                    q = pb[br * (k - 1) : (br + 1) * (k - 1)]
                    o = hits[br][0] & q[k - 2]
                    occ = o if occ is None else (occ | o)
                    new_pb.append(hits[br][k - 1])
                    for j in range(2, k):
                        new_pb.append(hits[br][k - j] & q[j - 2])
                new_pb = tuple(new_pb)
            r = jnp.where(occ, jnp.minimum(rb[-1] + 1, mm), 0)
            rb = (r,) + rb[:-1]
            return (rb, new_pb), r >= mm

        init = ((zi,) * k, (zb,) * max(R * (k - 1), 0))
        _, hits = jax.lax.scan(
            step, init, (dT, jnp.arange(T, dtype=jnp.int32)), reverse=True
        )
        return hits.T
