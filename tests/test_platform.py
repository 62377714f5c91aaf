"""The platform decision (roaringregex/platform.py): one place decides
the platform, interpret mode and the scan route for every caller."""
import os

import jax
import pytest

from roaringregex import platform
from roaringregex.compiler.program import compile_program


def test_platform_is_cpu_here():
    assert platform.platform() == "cpu"
    assert platform.interpret() is True
    assert platform.default_backend() == "packed"


def test_interpret_refused_on_gpu(monkeypatch):
    assert platform.interpret("gpu") is False
    assert platform.interpret("cpu") is True
    # the word kernel takes its flag from the platform: compiled on gpu
    seen = []
    import jax.experimental.pallas as pl

    real = pl.pallas_call

    def spy(*a, **k):
        seen.append(k["interpret"])
        return real(*a, **{**k, "interpret": True})

    monkeypatch.setattr(pl, "pallas_call", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    import numpy as np

    from roaringregex.ops.scan_word import WordScanner

    sc = WordScanner(compile_program("ab"))
    sc.match_stats_b(np.zeros((4, 8), np.uint8), np.zeros((4, 1), np.int32),
                     seeded=True)
    assert seen == [False]


def test_unsupported_platform_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        platform.platform()
    with pytest.raises(RuntimeError):
        platform.interpret("rocm")


@pytest.mark.parametrize(
    "pattern,gpu_route,cpu_route",
    [
        ("cat|dog", ("pallas", "word", True), ("packed", None, False)),
        ("[a-z]+\\.log$", ("pallas", "word", True), ("packed", None, False)),
        ("a{1,300}", ("packed", "count", True), ("packed", None, False)),
        ("a{3,1200}", ("xla", "count", True), ("xla", None, False)),
        ("x(ab|c){400,520}y", ("xla", None, True), ("xla", None, False)),
        ("[a-f]{10,55}", ("packed", None, True), ("packed", None, False)),
    ],
)
def test_route_per_platform(pattern, gpu_route, cpu_route):
    prog = compile_program(pattern)
    assert tuple(platform.route(prog, plat="gpu")) == gpu_route
    assert tuple(platform.route(prog, plat="cpu")) == cpu_route


def test_route_requests():
    from roaringregex.utils.config import get_config, set_config

    prog = compile_program("cat|dog")
    assert platform.route(prog, "xla").backend == "xla"
    assert platform.route(prog, "pallas", plat="cpu").kernel == "word"
    base = get_config()
    try:
        set_config(base.with_(backend="xla"))  # RRX_BACKEND's field
        assert platform.route(prog, plat="gpu").backend == "xla"
        assert platform.route(prog, "pallas", plat="gpu").kernel == "word"
    finally:
        set_config(base)
    with pytest.raises(ValueError, match="unknown backend"):
        platform.route(prog, "mosaic")


def test_route_multi_pattern_channels():
    from roaringregex.api import MultiPattern

    mp = MultiPattern(["cat|dog", "[0-9]{3}"])
    r = platform.route(mp.program, accept_map=mp.accept_map, P=2, plat="gpu")
    assert r.kernel == "word"
    # accept channels never take the single-channel run-length scanner
    mp2 = MultiPattern(["a{1,300}", "b"])
    r2 = platform.route(mp2.program, accept_map=mp2.accept_map, P=2, plat="gpu")
    assert r2.kernel != "count"


def test_compile_cache_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere")
        jax.config.update("jax_compilation_cache_dir", "/somewhere")
        platform.ensure_compile_cache()
        assert jax.config.jax_compilation_cache_dir == "/somewhere"
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        jax.config.update("jax_compilation_cache_dir", None)
        platform.ensure_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(platform.__file__)))
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            root, ".jax_cache"
        )
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_keyed_on_source():
    from roaringregex.compiler import native

    name = os.path.basename(native._lib_path())
    assert name.startswith("librrx_host-") and name.endswith(".so")
    assert name != "librrx_host.so"


@pytest.mark.gpu
def test_platform_on_gpu(gpu):
    """On the card: platform gpu, kernels compiled, pallas by default."""
    assert gpu.platform == "gpu"
    assert platform.platform() == "gpu"
    assert platform.interpret() is False
    assert platform.default_backend() == "pallas"
    prog = compile_program("cat|dog")
    assert platform.route(prog).kernel == "word"
