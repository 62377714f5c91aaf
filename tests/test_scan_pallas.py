"""The ``pallas`` route vs the unpacked XLA engine (interpret mode on CPU).

On the ``pallas`` route each program takes the word kernel, the run-length
scanner or the packed engine (``platform.route``); whatever it takes must
agree exactly with the unpacked reference engine (ops/scan_xla.py) on
every primitive and tile size.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from roaringregex.compiler.program import compile_program
from roaringregex.engine import ScanEngine
from roaringregex.ops import scan_xla as sx

PATTERNS = [
    "cat|dog",            # tile 8, G=16
    "(ab|cd)+e{2,3}fgh",  # tile 16
    "a{1,25}",            # tile 32
    "[a-f]{10,55}",       # tile 64
    "a{1,120}",           # tile 128 (G=1)
    "a{1,200}",           # tile 256 (dense256)
    "a{1,300}",           # tile 384 (multiblock)
    "(cat|dog)*",         # nullable
    "^ab?c$",             # anchors
]


def _setup(pattern, seed=0, n=40, maxlen=30, L=32):
    prog = compile_program(pattern)
    eng = ScanEngine(prog, backend="pallas")
    ref = ScanEngine(prog, backend="xla")
    rng = np.random.default_rng(seed)
    texts = [b"", b"cat", b"catdog", b"ababccd", b"abc", b"aaaaa"]
    for _ in range(n):
        ln = int(rng.integers(0, maxlen))
        texts.append(
            bytes(rng.choice(list(b"abcdefgcat.dog"), size=ln).astype(np.uint8))
        )
    G = prog.G
    Bp = max(G, ((len(texts) + G - 1) // G) * G)
    data = np.zeros((Bp, L), np.uint8)
    lengths = np.zeros(Bp, np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    return prog, eng, ref, data, lengths


@pytest.mark.parametrize("pattern", PATTERNS)
def test_pallas_match_stats_parity(pattern):
    prog, eng, ref, data, lengths = _setup(pattern)
    for seeded in (True, False):
        for name, x, y in zip(
            ("cnt", "first", "any"),
            eng.match_stats(data, lengths, seeded=seeded),
            ref.match_stats(data, lengths, seeded=seeded),
        ):
            np.testing.assert_array_equal(
                np.asarray(x), np.asarray(y), err_msg=f"{pattern} {name}"
            )
    np.testing.assert_array_equal(
        eng.fullmatch_flags(data, lengths), ref.fullmatch_flags(data, lengths)
    )


@pytest.mark.parametrize("pattern", PATTERNS)
def test_pallas_forward_flags_parity(pattern):
    prog, eng, ref, data, lengths = _setup(pattern, seed=1)
    for seeded in (True, False):
        flp = np.asarray(eng.forward_flags(data, lengths, seeded=seeded))
        flk = np.asarray(ref.forward_flags(data, lengths, seeded=seeded))
        np.testing.assert_array_equal(flp, flk, err_msg=f"{pattern} {seeded}")


@pytest.mark.parametrize("pattern", PATTERNS)
def test_pallas_reverse_hits_parity(pattern):
    prog, eng, ref, data, lengths = _setup(pattern, seed=2)
    hp = np.asarray(eng.reverse_hits(data, lengths))
    hk = np.asarray(ref.reverse_hits(data, lengths))
    np.testing.assert_array_equal(hp, hk, err_msg=pattern)


def test_pallas_multi_chunk_grid():
    """B and L big enough for several word-kernel record blocks and a
    long byte loop, vs the packed and unpacked engines."""
    prog = compile_program("cat|dog")
    eng = ScanEngine(prog, backend="pallas")
    assert eng.route.kernel == "word"
    rng = np.random.default_rng(3)
    G = prog.G
    B, L = 64 * G, 600  # 1024 records -> 8 blocks of 128, 601 steps
    data = rng.integers(97, 123, size=(B, L), dtype=np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    ck, fk, _ = eng.match_stats(data, lengths, seeded=True)
    for backend in ("packed", "xla"):
        cp, fp, _ = ScanEngine(prog, backend=backend).match_stats(
            data, lengths, seeded=True
        )
        np.testing.assert_array_equal(np.asarray(cp), np.asarray(ck))
        np.testing.assert_array_equal(np.asarray(fp), np.asarray(fk))
