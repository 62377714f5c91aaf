"""Packed/pallas anchored-rescan parity vs the unpacked engine."""
import numpy as np
import pytest

import jax.numpy as jnp

from roaringregex.compiler.program import compile_program
from roaringregex.engine import ScanEngine
from roaringregex.ops import scan_xla as sx

PATTERNS = ["cat|dog", "(ab)*c+d?", "[a-f]{2,9}", "a{1,200}", "^ab", "ab$"]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("backend", ["packed", "pallas"])
def test_first_end_parity(pattern, backend):
    prog = compile_program(pattern)
    eng = ScanEngine(prog, backend=backend)
    ref = ScanEngine(prog, backend="xla")
    rng = np.random.default_rng(9)
    G = prog.G
    B, L = 4 * max(G, 8), 24
    data = rng.choice(list(b"abcdefcatdog"), size=(B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    starts = rng.integers(-1, L, size=B).astype(np.int32)
    got = np.asarray(eng.first_end_from(data, lengths, starts))
    exp = np.asarray(ref.first_end_from(data, lengths, starts))
    # unpacked path may report ends for inactive (-1) records; mask those
    act = starts >= 0
    np.testing.assert_array_equal(got[act], exp[act], err_msg=pattern)


def test_finditer_spans_still_exact():
    import roaringregex as rrx
    from roaringregex.oracle.engine import OracleEngine

    pat = rrx.Pattern("(ab)*c+d?", backend="pallas")
    orc = OracleEngine(pat.program.nfa)
    texts = ["ababccd", "c", "ccabcabd", "", "ababababccccd"]
    assert pat.finditer_batch(texts) == [orc.findall(t) for t in texts]
