"""Config + profiling utilities."""
import numpy as np

from roaringregex.utils import RrxConfig, ScanTimer, get_config, set_config


def test_config_override_roundtrip():
    base = get_config()
    try:
        set_config(base.with_(long_block=512, backend="packed"))
        assert get_config().long_block == 512
        assert get_config().backend == "packed"
        # engine consumes the override
        from roaringregex.api import Pattern

        p = Pattern.__new__(Pattern)  # avoid cache; construct manually
        from roaringregex.compiler.program import compile_program
        from roaringregex.engine import ScanEngine

        eng = ScanEngine(compile_program("abc"))
        assert eng.backend == "packed"
    finally:
        set_config(base)


def test_scan_timer_accounting():
    import jax.numpy as jnp

    t = ScanTimer(name="t")
    f = lambda x: x + 1
    t.timed(f, jnp.zeros(4), nbytes=100)  # compile call
    t.timed(f, jnp.zeros(4), nbytes=100)
    t.timed(f, jnp.zeros(4), nbytes=100)
    assert t.compile_s is not None and len(t.times_s) == 2
    assert t.bytes_done == 200
    assert t.bytes_per_sec() > 0
    assert "GB/s" in t.report()


def test_throughput_report_smoke():
    from roaringregex.utils.profiling import throughput_report

    data = np.full((16, 32), ord("a"), np.uint8)
    lengths = np.full(16, 32, np.int32)
    out = throughput_report(["a*b?", "cat|dog"], data, lengths, iters=1)
    assert set(out) == {"a*b?", "cat|dog"} and all(v > 0 for v in out.values())
