""">256-state band-structured automata on the plain XLA route.

``{m,n}`` shapes whose follow matrix is a few diagonals plus an
optional-tail skip triangle scan through the unpacked XLA engine (sparse
tier) or the packed engine (multiblock tier), and must agree with the
oracle on counts, fullmatch and spans.
"""
import numpy as np
import pytest

from roaringregex.api import Pattern
from roaringregex.oracle.engine import OracleEngine
from roaringregex.utils.config import get_config, set_config


@pytest.fixture
def sparse_cfg():
    """Force the raw sparse scan: no seeded alias, no prefilter, and a
    low dense_max so moderately sized test patterns hit the sparse tier
    (the CPU cannot afford 1500-state automata per case)."""
    base = get_config()
    set_config(
        base.with_(seeded_alias=False, sparse_prefilter=False, dense_max=256)
    )
    yield
    set_config(base)


# (pattern, alphabet) — all >256 states under dense_max=256, each shaped
# to exercise one decomposition branch: pure band, band+triangle,
# triangle with multiple families, rank-1 loop-backs
CASES = [
    ("x[a-c]{280,300}", "xabc"),  # 1 diag + 1-family triangle
    ("x(ab|c){100,120}y", "xabcy"),  # 4 diags + 2-family triangle
    ("a{300}", "ab"),  # pure band, no residual
    ("(ab|cde){80,100}f", "abcdef"),  # mixed-length bodies, wider band
    ("x(ab|c){120,}", "xabc"),  # {m,}: loop-back rank-1 columns
]


def _texts(pattern, alpha, rng, n=8):
    ts = [
        "",
        "x" + "ab" * 60 + "c" * 20 + "y",
        "x" + "c" * 110 + "y",
        "ab" * 150,
        "a" * 300,
        "x" + "abc" * 100,
        "cde" * 40 + "ab" * 50 + "f",
    ]
    for _ in range(n):
        ln = int(rng.integers(0, 500))
        ts.append("".join(rng.choice(list(alpha), size=ln)))
    return ts


@pytest.mark.parametrize("pattern,alpha", CASES)
def test_bitband_oracle_parity(pattern, alpha, sparse_cfg):
    p = Pattern(pattern, backend="pallas")
    assert p.tier == "sparse", p.program.n_states
    assert p.engine.backend == "xla"
    assert p.engine.route.kernel in (None, "count")
    orc = OracleEngine(p.program.nfa)
    rng = np.random.default_rng(7)
    texts = _texts(pattern, alpha, rng)
    cnt = p.count_batch(texts)
    fm = p.fullmatch_batch(texts)
    for t, c, f in zip(texts, cnt, fm):
        assert int(c) == len(orc.ends(t)), (pattern, len(t))
        assert bool(f) == orc.fullmatch(t), (pattern, len(t))
    # spans: lazy + greedy on a text with real matches
    t = texts[1][:400]
    assert p.finditer_batch([t])[0] == orc.findall(t), pattern
    assert p.finditer_batch([t], longest=True)[0] == orc.findall(
        t, longest=True
    ), pattern


def test_bitband_fuzz_vs_oracle(sparse_cfg):
    """Randomized {m,n} patterns with random context, counts vs oracle."""
    rng = np.random.default_rng(23)
    bodies = ["(ab|c)", "[a-d]", "(ab|cd|e)", "(abc|d)"]
    for trial in range(6):
        body = bodies[trial % len(bodies)]
        m = int(rng.integers(60, 120))
        n = m + int(rng.integers(5, 40))
        pre = rng.choice(["x", "", "xy"])
        post = rng.choice(["y", "", "z"])
        pat = f"{pre}{body}{{{m},{n}}}{post}"
        p = Pattern(pat, backend="pallas")
        if p.tier != "sparse":
            continue
        orc = OracleEngine(p.program.nfa)
        texts = []
        for _ in range(6):
            ln = int(rng.integers(0, 420))
            texts.append(
                "".join(rng.choice(list("abcdexyz"), size=ln))
            )
        # plant a guaranteed hit
        texts.append(str(pre) + "ab" * n + str(post))
        cnt = p.count_batch(texts)
        for t, c in zip(texts, cnt):
            assert int(c) == len(orc.ends(t)), (pat, len(t))


def test_bitband_multiblock_tier():
    """256 < S <= 1024 context-wrapped {m,n} patterns (the multiblock
    family) route to the packed engine."""
    base = get_config()
    set_config(base.with_(seeded_alias=False))
    try:
        p = Pattern("x(ab|c){100,120}y", backend="pallas")
        assert p.tier == "multiblock"
        assert p.engine.backend == "packed"
        assert p.engine.device_scanner is None
        orc = OracleEngine(p.program.nfa)
        rng = np.random.default_rng(17)
        texts = ["x" + "ab" * 50 + "c" * 15 + "y", ""]
        for _ in range(6):
            ln = int(rng.integers(0, 400))
            texts.append("".join(rng.choice(list("xabcy"), size=ln)))
        cnt = p.count_batch(texts)
        fm = p.fullmatch_batch(texts)
        for t, c, f in zip(texts, cnt, fm):
            assert int(c) == len(orc.ends(t)), len(t)
            assert bool(f) == orc.fullmatch(t), len(t)
        t = texts[0][:300]
        assert p.finditer_batch([t])[0] == orc.findall(t)
    finally:
        set_config(base)
