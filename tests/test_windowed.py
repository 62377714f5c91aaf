"""Windowed batch scan (engine._window_plan / _match_stats_windowed).

Splitting long records into overlapped windows (lead=h warm-up prefix,
window-owned ends only) must be exactly transparent for the lazy stats
triple (cnt, first_end, any). Opt-in via RrxConfig.window_cols (default
off — see utils/config.py); these tests force it on.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from roaringregex.compiler.program import compile_program  # noqa: E402
from roaringregex.engine import ScanEngine  # noqa: E402
from roaringregex.utils.config import get_config, set_config  # noqa: E402


@pytest.fixture()
def window_cfg():
    # engine-level windowing targets the word kernel (it takes ``lead``)
    old = get_config()
    set_config(old.with_(window_cols=2048))
    yield
    set_config(old)


def _mk_batch(rng, pat_bytes, B, L):
    data = rng.integers(97, 123, size=(B, L), dtype=np.uint8)
    w = np.frombuffer(pat_bytes, np.uint8)
    # plant matches at window-boundary-ish offsets and record edges
    for b in range(B):
        for pos in (0, L // 4 - 1, L // 4, L // 2, L - len(w)):
            if rng.random() < 0.5 and pos + len(w) <= L:
                data[b, pos : pos + len(w)] = w
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[0] = L
    lengths[1] = 0
    return data, lengths


@pytest.mark.parametrize("pattern,plant", [
    ("cat|dog", b"cat"),
    ("a[bc]d", b"abd"),
    ("[a-z]x{2,5}", b"qxxx"),
])
@pytest.mark.parametrize("L", [300, 1000])
def test_windowed_stats_parity(window_cfg, pattern, plant, L):
    prog = compile_program(pattern)
    eng = ScanEngine(prog, backend="pallas")
    G = max(1, prog.G)
    rng = np.random.default_rng(hash((pattern, L)) % 2**32)
    data, lengths = _mk_batch(rng, plant, 2 * G, L)
    d, l = jnp.asarray(data), jnp.asarray(lengths)

    plan = eng._window_plan(L, data.shape[0], True)
    assert plan is not None and plan[0] >= 2
    w_cnt, w_first, w_any = (
        np.asarray(x) for x in eng._match_stats_windowed(d, l, *plan)
    )

    set_config(get_config().with_(window_cols=0))
    n_cnt, n_first, n_any = (
        np.asarray(x) for x in eng.match_stats(d, l, seeded=True)
    )
    set_config(get_config().with_(window_cols=2048))

    np.testing.assert_array_equal(w_cnt, n_cnt)
    np.testing.assert_array_equal(w_first, n_first)
    np.testing.assert_array_equal(w_any, n_any)


def test_window_plan_gates(window_cfg):
    """Anchored, nullable, cyclic-horizon, and unseeded scans must not plan."""
    G = compile_program("cat|dog").G
    B, L = 2 * G, 1024

    eng = ScanEngine(compile_program("cat|dog"), backend="pallas")
    assert eng._window_plan(L, B, True) is not None
    assert eng._window_plan(L, B, False) is None  # unseeded (fullmatch)
    assert eng._window_plan(200, B, True) is None  # records too short

    for pat in ("^cat", "dog$", "a*", "(ab)*c"):
        e = ScanEngine(compile_program(pat), backend="pallas")
        assert e._window_plan(L, B, True) is None, pat


def test_match_stats_routes_through_windows(window_cfg):
    """With window_cols on, engine.match_stats itself takes the split path
    and still matches the oracle-equivalent unsplit result."""
    prog = compile_program("cat|dog")
    eng = ScanEngine(prog, backend="pallas")
    G = prog.G
    rng = np.random.default_rng(7)
    data, lengths = _mk_batch(rng, b"dog", 2 * G, 600)
    d, l = jnp.asarray(data), jnp.asarray(lengths)
    a = tuple(np.asarray(x) for x in eng.match_stats(d, l, seeded=True))
    set_config(get_config().with_(window_cols=0))
    b = tuple(np.asarray(x) for x in eng.match_stats(d, l, seeded=True))
    set_config(get_config().with_(window_cols=2048))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
