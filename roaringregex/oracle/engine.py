"""Pure-Python oracle NFA simulator -- the executable spec.

This is the semantic ground truth the device engine must agree with
byte-for-byte (SURVEY.md SS4.2). It implements the reference's verified
semantics (whole-string acceptance, SURVEY.md SS2.8) *plus* the capabilities
the reference declared but never finished, with the documented fixes:

* anchors ``^``/``$`` work (via virtual BOS/EOS symbols), instead of being
  unmatchable NUL literals (reference defect SS2.12.4);
* lazy span iteration (``finditer``) exists for real -- the reference's
  Iterator.cpp is an empty placeholder and its backward-scan machinery is
  dead code (SS2.10, SS3.3);
* state ids are unbounded Python ints, not uint8-truncated (SS2.12.1).

Matching semantics (normative):

* The *extended symbol stream* of ``text`` starting at position ``s`` is
  ``[BOS if s == 0] + bytes(text[s:]) + [EOS]``. Bytes >= 0x80 map to a dead
  symbol with no transitions (the reference is ASCII-only, NFA.cc:25).
* After consuming ``k`` stream symbols the *real end position* is
  ``min(s + (k - 1 if s == 0 else k), len)`` -- virtual symbols do not
  advance the position.
* ``fullmatch``: run unseeded from s=0; accept iff some stream point with
  end == len has an accepting state active.
* ``finditer`` (lazy, non-overlapping, normative policy): leftmost start
  first; for that start, the *shortest* end; empty matches allowed, after
  which the scan position advances by one.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Set, Tuple

from ..compiler.nfa import NFA, build_nfa
from ..compiler.parser import BOS, EOS, NSYM


class OracleEngine:
    """Set-semantics simulator over Python int bitmasks (tier-free: this is
    the same algebra all device tiers must reproduce)."""

    def __init__(self, nfa: NFA):
        self.nfa = nfa
        self.follow = nfa.follow_ints()  # [S] int bitmask
        self.symtab = nfa.symtab_ints()  # [NSYM] int bitmask
        self.accept = nfa.accept_int()
        self.nullable = nfa.nullable
        self.n_states = nfa.n_states

    @classmethod
    def compile(cls, pattern: str) -> "OracleEngine":
        return cls(build_nfa(pattern))

    # ------------------------------------------------------------------
    # Core algebra
    # ------------------------------------------------------------------
    def _expand(self, D: int) -> int:
        """follow(D) = union of follow rows of members -- the hot loop the
        device engine turns into a matrix product (reference: NFA.cc:86-100)."""
        out = 0
        i = 0
        while D:
            if D & 1:
                out |= self.follow[i]
            D >>= 1
            i += 1
        return out

    def step(self, D: int, sym: int) -> int:
        b = self.symtab[sym] if 0 <= sym < NSYM else 0
        return self._expand(D) & b

    # ------------------------------------------------------------------
    # Stream helpers
    # ------------------------------------------------------------------
    @staticmethod
    def _stream(data: bytes, s: int) -> List[int]:
        syms: List[int] = [BOS] if s == 0 else []
        syms.extend(b if b < 128 else NSYM for b in data[s:])  # NSYM = dead
        syms.append(EOS)
        return syms

    @staticmethod
    def _ends_for(data: bytes, s: int) -> List[int]:
        """Real end position after consuming k=1.. symbols of _stream(data,s)."""
        n = len(data)
        ends = []
        pos = s
        if s == 0:
            ends.append(0)  # BOS consumed
        for i in range(s, n):
            pos = i + 1
            ends.append(pos)
        ends.append(n)  # EOS consumed
        return ends

    # ------------------------------------------------------------------
    # Matching entry points
    # ------------------------------------------------------------------
    def fullmatch(self, text: str | bytes) -> bool:
        """Whole-string acceptance -- the reference's verified semantics
        (AcceptanceIterator, regex.h:150-165)."""
        data = _as_bytes(text)
        n = len(data)
        D = 1  # {initial}
        if n == 0 and (self.accept & 1):
            return True
        syms = self._stream(data, 0)
        ends = self._ends_for(data, 0)
        for k, (sym, e) in enumerate(zip(syms, ends)):
            D = self.step(D, sym)
            if k == 0 and sym == BOS:
                # Position 0 exists both before and after the virtual BOS:
                # re-inject the initial state so non-anchored patterns are
                # not forced to consume BOS.
                D |= 1
            if e == n and (D & self.accept):
                return True
            if not D and e < n:
                return False
        return False

    def first_end_from(self, data: bytes, s: int) -> Optional[int]:
        """Smallest e such that text[s:e] matches (anchored at s), or None.
        This defines the 'lazy' (shortest) match length."""
        D = 1
        if self.accept & 1:
            return s  # empty match
        syms = self._stream(data, s)
        ends = self._ends_for(data, s)
        for k, (sym, e) in enumerate(zip(syms, ends)):
            D = self.step(D, sym)
            if k == 0 and sym == BOS:
                D |= 1  # see fullmatch: start 0 exists on both sides of BOS
            if D & self.accept & ~1:
                return e
            if not D:
                return None
        return None

    def last_end_from(self, data: bytes, s: int) -> Optional[int]:
        """Largest e such that text[s:e] matches (anchored at s), or None.
        This defines the 'greedy' (leftmost-longest, POSIX) match length —
        the policy the reference declared but never implemented
        (README.md:55 "Greedy iterater not greedy", regex.h:150-165)."""
        D = 1
        best: Optional[int] = s if (self.accept & 1) else None
        syms = self._stream(data, s)
        ends = self._ends_for(data, s)
        for k, (sym, e) in enumerate(zip(syms, ends)):
            D = self.step(D, sym)
            if k == 0 and sym == BOS:
                D |= 1  # see fullmatch: start 0 exists on both sides of BOS
            if D & self.accept & ~1:
                best = e
            if not D:
                break
        return best

    def ends(self, text: str | bytes) -> Set[int]:
        """All positions e where *some* match (any start) ends -- the seeded
        forward scan the device 'ends bitmap' kernel must reproduce."""
        data = _as_bytes(text)
        n = len(data)
        out: Set[int] = set()
        D = 1
        if self.nullable:
            # empty match ends at every position (a fresh seed exists there)
            out.update(range(n + 1))
        syms = self._stream(data, 0)
        ends = self._ends_for(data, 0)
        for sym, e in zip(syms, ends):
            D = self.step(D | 1, sym)  # seed a fresh start before each symbol
            if D & self.accept:
                out.add(e)
        return out

    def starts(self, text: str | bytes) -> Set[int]:
        """All positions s where some match starts (O(n^2) direct def)."""
        data = _as_bytes(text)
        return {
            s
            for s in range(len(data) + 1)
            if self.first_end_from(data, s) is not None
        }

    def search(self, text: str | bytes) -> bool:
        data = _as_bytes(text)
        return any(
            self.first_end_from(data, s) is not None for s in range(len(data) + 1)
        )

    def match(self, text: str | bytes) -> Optional[int]:
        """Anchored-at-0 lazy match; returns the end position or None."""
        data = _as_bytes(text)
        return self.first_end_from(data, 0)

    def finditer(
        self, text: str | bytes, *, longest: bool = False
    ) -> Iterator[Tuple[int, int]]:
        """Non-overlapping span enumeration (normative policies).

        Leftmost start; for that start the shortest end (lazy, default) or
        the longest end (``longest=True``, greedy leftmost-longest — POSIX
        semantics). Empty matches advance the scan position by one (like
        Python ``re``).
        """
        data = _as_bytes(text)
        n = len(data)
        pick = self.last_end_from if longest else self.first_end_from
        pos = 0
        while pos <= n:
            hit = None
            for s in range(pos, n + 1):
                e = pick(data, s)
                if e is not None:
                    hit = (s, e)
                    break
            if hit is None:
                return
            yield hit
            s, e = hit
            pos = e if e > s else s + 1

    def findall(
        self, text: str | bytes, *, longest: bool = False
    ) -> List[Tuple[int, int]]:
        return list(self.finditer(text, longest=longest))


def _as_bytes(text: str | bytes) -> bytes:
    return text.encode("ascii", errors="strict") if isinstance(text, str) else bytes(text)
