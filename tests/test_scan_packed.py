"""Parity tests: lane-packed engine vs unpacked XLA engine vs oracle.

Covers every tile size (s_tile 8..256) and all three primitives
(match_stats, forward_flags, reverse_hits). The packed engine must be
bit-identical to the unpacked one — same stream convention, same counting.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from roaringregex.compiler.program import compile_program
from roaringregex.ops import scan_packed as sp
from roaringregex.ops import scan_xla as sx
from roaringregex.oracle.engine import OracleEngine

# pattern -> expected s_tile
TIER_PATTERNS = [
    ("cat|dog", 8),
    ("(ab)*c+d?", 8),
    ("a*", 8),
    ("^ab?c$", 8),
    ("(ab|cd)+e{2,3}fgh", 16),
    ("a{1,25}", 32),
    ("[a-f]{10,55}", 64),
    ("a{1,120}", 128),
    ("a{1,200}", 256),
    ("a{1,300}", 384),
    ("(ab){50,260}", 640),
    ("a{1,1000}", 1024),
]


def _texts(rng, alphabet=b"abcdefgxyz. ", n=32, maxlen=24):
    out = [b"", b"a", b"cat", b"dog", b"catdog", b"ababccd", b"aaaa"]
    for _ in range(n):
        ln = int(rng.integers(0, maxlen))
        out.append(bytes(rng.choice(list(alphabet), size=ln).astype(np.uint8)))
    return out


def _pack(prog, texts, L=32):
    G = prog.G
    B = len(texts)
    Bp = ((B + G - 1) // G) * G
    Bp = max(Bp, G)
    data = np.zeros((Bp, L), np.uint8)
    lengths = np.zeros(Bp, np.int32)
    for i, t in enumerate(texts):
        data[i, : len(t)] = np.frombuffer(t, np.uint8)
        lengths[i] = len(t)
    return data, lengths, Bp


@pytest.mark.parametrize("pattern,s_tile", TIER_PATTERNS)
def test_packed_matches_unpacked_and_oracle(pattern, s_tile):
    prog = compile_program(pattern)
    assert prog.s_tile == s_tile, (prog.s_tile, s_tile, prog.n_states)
    tab_u = sx.device_tables(prog)
    tab_p = sp.packed_tables(prog)
    oracle = OracleEngine(prog.nfa)

    rng = np.random.default_rng(42)
    texts = _texts(rng)
    data, lengths, Bp = _pack(prog, texts)
    cls = sx.encode_stream(
        tab_u,
        jnp.asarray(data),
        jnp.asarray(lengths),
        prog.bos_class,
        prog.eos_class,
        prog.dead_class,
    )
    words = sp.pack_mask_stream(tab_p, cls, s_tile=prog.s_tile, G=prog.G)
    len_g = jnp.asarray(lengths).reshape(-1, prog.G)

    # ---- match_stats parity ----
    for seeded in (True, False):
        cu, fu, au = sx.match_stats(
            tab_u, cls, jnp.asarray(lengths), seeded=seeded, nullable=prog.nullable
        )
        cp, fp, ap = sp.match_stats(
            tab_p,
            words,
            len_g,
            seeded=seeded,
            nullable=prog.nullable,
            lanes=prog.lanes,
        )
        B = Bp
        np.testing.assert_array_equal(np.asarray(cu), np.asarray(cp).reshape(B))
        np.testing.assert_array_equal(np.asarray(fu), np.asarray(fp).reshape(B))
        np.testing.assert_array_equal(np.asarray(au), np.asarray(ap).reshape(B))

    # oracle check on the seeded counts (distinct match ends per record)
    cp, _, _ = sp.match_stats(
        tab_p, words, len_g, seeded=True, nullable=prog.nullable, lanes=prog.lanes
    )
    cp = np.asarray(cp).reshape(Bp)
    for i, t in enumerate(texts):
        assert cp[i] == len(oracle.ends(t)), (pattern, t)

    # ---- forward_flags parity ----
    for seeded in (True, False):
        flu = np.asarray(sx.forward_flags(tab_u, cls, seeded=seeded))
        flp = np.asarray(
            sp.forward_flags(tab_p, words, seeded=seeded, lanes=prog.lanes)
        )
        np.testing.assert_array_equal(flu, flp, err_msg=f"{pattern} seeded={seeded}")

    # ---- reverse_hits parity ----
    hu = np.asarray(sx.reverse_hits(tab_u, cls))
    hp = np.asarray(sp.reverse_hits(tab_p, words, lanes=prog.lanes))
    np.testing.assert_array_equal(hu, hp, err_msg=pattern)


def test_api_uses_packed_backend_consistently():
    """End-to-end Pattern API on a packed tier agrees with the oracle."""
    import roaringregex as rrx

    pat = rrx.compile("(cat|dog)+")
    oracle = OracleEngine(pat.program.nfa)
    texts = ["catdog", "dog", "", "ccat", "dogdogdogx", "catca"]
    full = pat.fullmatch_batch(texts)
    for t, f in zip(texts, full):
        assert bool(f) == oracle.fullmatch(t), t
    spans = pat.finditer_batch(texts)
    for t, sp_ in zip(texts, spans):
        assert sp_ == oracle.findall(t), (t, sp_)
