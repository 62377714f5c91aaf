"""Device-side span enumeration (O(1)-dispatch finditer) vs the oracle.

Both policies run as one device program (engine.spans over
scan_packed.spans_rounds: one reverse pass, then a while_loop of anchored
rescans — shortest end for lazy, longest end for greedy). Both must agree
byte-for-byte with OracleEngine.finditer and with the host-driven round
loop of the non-pallas backends.
"""
import numpy as np
import pytest

from roaringregex.api import Pattern
from roaringregex.oracle.engine import OracleEngine

PATTERNS = [
    "cat|dog",
    "a+",
    "(ab)+c?",
    "^a+",
    "a+$",
    "[a-c]{2,5}",
    "a*",            # nullable (trivial lazy path / greedy fallback)
    "(cat|dog)*",    # nullable
    "a|ab",          # POSIX-longest-sensitive
    "(ab|cd)+e{2,3}f",  # tile 16
]


def _texts(seed=11, n=40):
    rng = np.random.default_rng(seed)
    texts = [b"", b"cat", b"catcatdog", b"aaaa", b"abababc", b"xxaxx"]
    for _ in range(n):
        ln = int(rng.integers(0, 24))
        texts.append(
            bytes(rng.choice(list(b"abcdogcat"), size=ln).astype(np.uint8))
        )
    return texts


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("longest", [False, True])
def test_device_spans_vs_oracle(pattern, longest):
    p = Pattern(pattern, backend="pallas")
    assert p.engine.device_spans
    o = OracleEngine(p.program.nfa)
    texts = _texts()
    got = p.finditer_batch(texts, longest=longest)
    for t, g in zip(texts, got):
        want = list(o.finditer(t, longest=longest))
        assert g == want, (pattern, longest, t, g, want)


def test_device_spans_match_host_rounds():
    """Device path == host-round path (packed backend) on the same batch."""
    texts = _texts(seed=3)
    for pattern in ["cat|dog", "a+", "a|ab"]:
        pd = Pattern(pattern, backend="pallas")
        ph = Pattern(pattern, backend="packed")
        for longest in (False, True):
            assert pd.finditer_batch(texts, longest=longest) == ph.finditer_batch(
                texts, longest=longest
            ), (pattern, longest)


def test_cap_presized_no_retry():
    """A pathological record (1000 matches) runs with ONE spans dispatch:
    the cap is pre-sized from a counts pass (n_spans <= distinct match
    ends), so the quadruple-and-recompile overflow loop never fires."""
    p = Pattern("a", backend="pallas")
    eng = p.engine
    calls = []
    orig = eng.spans
    eng.spans = lambda *a, **k: calls.append(k["cap"]) or orig(*a, **k)
    try:
        t = b"a" * 1000  # 1000 spans >> the old initial cap of 8
        got = p.finditer_batch([t])[0]
        assert got == [(i, i + 1) for i in range(1000)]
        assert calls == [1024], calls  # one dispatch, pow2-bucketed cap
        calls.clear()
        got_g = p.finditer_batch([t], longest=True)[0]
        assert got_g == [(i, i + 1) for i in range(1000)]
        assert calls == [1024], calls
    finally:
        eng.spans = orig
