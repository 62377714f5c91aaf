"""Oracle-side expectations for the scanners' match statistics."""
import numpy as np

from roaringregex.oracle.engine import OracleEngine


def anchored_ends(orc, t: bytes):
    """Ends of the matches that start at 0 (the oracle's own walk)."""
    out = {0} if orc.nullable else set()
    D = 1
    for k, (sym, e) in enumerate(zip(orc._stream(t, 0), orc._ends_for(t, 0))):
        D = orc.step(D, sym)
        if k == 0:
            D |= 1  # start 0 exists on both sides of BOS
        if D & orc.accept & ~1:
            out.add(e)
        if not D:
            break
    return out


def oracle_stats(orc, t: bytes, seeded: bool):
    """(cnt, first, last, full, any) from the oracle: ends of any match
    (seeded) or of matches anchored at 0 (unseeded)."""
    ends = orc.ends(t) if seeded else anchored_ends(orc, t)
    return (
        len(ends),
        min(ends) if ends else -1,
        max(ends) if ends else -1,
        orc.fullmatch(t),
        bool(ends),
    )


def assert_stats_match_oracle(prog, out, data, lengths, seeded, tag=""):
    """Word-kernel stats vs the oracle; ``last`` of a nullable seeded
    program reports the last non-empty match end, so it is checked on
    non-nullable programs only."""
    orc = OracleEngine(prog.nfa)
    cnt, first, last, full, anyf = (np.asarray(x).reshape(-1) for x in out)
    for i in range(len(lengths)):
        t = bytes(data[i, : lengths[i]])
        c, f, l, fm, a = oracle_stats(orc, t, seeded)
        assert cnt[i] == c, (tag, t, "cnt", cnt[i], c)
        assert first[i] == f, (tag, t, "first", first[i], f)
        if not prog.nullable:
            assert last[i] == l, (tag, t, "last", last[i], l)
        assert bool(anyf[i]) == a, (tag, t, "any")
        if not seeded:
            assert bool(full[i]) == fm, (tag, t, "full")
