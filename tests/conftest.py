"""Test harness config: an 8-device virtual CPU mesh unless asked for the GPU.

Tests run on the CPU: kernels through the XLA CPU backend or Pallas
interpret mode, and multi-device sharding on
``--xla_force_host_platform_device_count``. ``chip_smoke.py`` sets
``RRX_TEST_GPU=1`` to run the ``gpu``-marked tests on the card
(``pytest -m gpu``); those tests decide inside the ``gpu`` fixture, never
at import time, whether a card is present.
"""
import atexit
import os
import shutil
import tempfile

if os.environ.get("RRX_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
# Isolate the persistent XLA compile cache per test run: concurrent
# writers can corrupt a shared cache file, and a corrupted entry can crash
# jax on read. Tests compile fast on CPU; cross-run reuse is not worth the
# hazard.
_cache_dir = tempfile.mkdtemp(prefix="rrx_jax_test_")
os.environ["JAX_COMPILATION_CACHE_DIR"] = _cache_dir
atexit.register(shutil.rmtree, _cache_dir, True)

import jax  # noqa: E402

import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The GPU device for a ``gpu``-marked test; skips without one."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run `pytest -m gpu` on the card)")
    return devs[0]


@pytest.fixture(autouse=True, scope="module")
def _bounded_jit_state():
    """Drop jit/executable caches after each test module: the XLA CPU
    compiler has been observed to segfault late in a long single-process
    run (hundreds of accumulated executables), and per-module clearing
    bounds that state at negligible recompile cost."""
    yield
    gc.collect()
    jax.clear_caches()
