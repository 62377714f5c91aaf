"""Block-sparse (>1024-state) tier on the ``pallas`` route.

S > 1024 patterns scan through the unpacked XLA engine, or the run-length
scanner where a counting plan applies. Must agree with the oracle.
"""
import numpy as np
import pytest

from roaringregex.api import Pattern
from roaringregex.oracle.engine import OracleEngine

PATTERNS = ["a{3,1200}", "(ab){10,600}", "x[a-c]{1030,1060}"]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_sparse_pallas_parity(pattern):
    p = Pattern(pattern, backend="pallas")
    assert p.tier == "sparse"
    assert p.engine.backend == "xla"
    if p.engine.route.kernel == "count":
        assert pattern in ("a{3,1200}", "(ab){10,600}")
    orc = OracleEngine(p.program.nfa)
    rng = np.random.default_rng(1)
    texts = ["", "a" * 3, "ab" * 12, "a" * 1200, "ab" * 600, "x" + "abc" * 350]
    for _ in range(6):
        ln = int(rng.integers(0, 80))
        texts.append("".join(rng.choice(list("abxc"), size=ln)))
    fm = p.fullmatch_batch(texts)
    for t, f in zip(texts, fm):
        assert bool(f) == orc.fullmatch(t), (pattern, len(t))
    cnt = p.count_batch(texts)
    for t, c in zip(texts, cnt):
        assert int(c) == len(orc.ends(t)), (pattern, len(t))
    # spans on a moderate text (exercises reverse + anchored rescans)
    t = texts[5][:120]
    assert p.finditer_batch([t])[0] == orc.findall(t), pattern


def test_sparse_cap_falls_back_to_xla():
    """A sparse structure with no counting plan routes to the XLA engine
    on every platform, and stays exact."""
    from roaringregex import platform

    # variable-length branches: no counting plan (equal-length bodies
    # like (a|b|c){...} route to the run-length scanner)
    p = Pattern("(ab|c){520,550}", backend="pallas")
    assert p.tier == "sparse"
    assert p.engine.backend == "xla" and p.engine.device_scanner is None
    for plat in ("gpu", "cpu"):
        assert platform.route(p.program, plat=plat).backend == "xla"
    orc = OracleEngine(p.program.nfa)
    ts = ["a" * 1039, "abc" * 350, "ab" * 520]
    fm = p.fullmatch_batch(ts)
    for t, f in zip(ts, fm):
        assert bool(f) == orc.fullmatch(t), len(t)
