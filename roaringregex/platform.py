"""Platform decision and scan routing: the one place that chooses a path.

The program runs on an NVIDIA GPU (``gpu``) or, for tests and CPU users,
on the host (``cpu``); any other JAX platform raises. This module is the
only place that decides whether a Pallas kernel runs in interpret mode:
it does so on ``cpu`` only. On ``gpu`` a kernel is compiled for the card,
and one that cannot compile raises — there is no fallback to interpret
mode or to another path.

:func:`route` picks the scan path for one compiled program. The batch
engine (``engine.ScanEngine``), the mesh scanner (``parallel.DistScanner``)
and the long-string scanners (``ops.longstring``) all call it. Backend
names:

* ``xla``    -- the unpacked per-byte ``lax.scan`` engine (any tier);
* ``packed`` -- the lane-packed per-byte ``lax.scan`` engine (dense tiers);
* ``pallas`` -- the Pallas-Triton word kernel (``ops.scan_word``) for
  programs that qualify, the plain path for the rest. Default on ``gpu``.

``packed`` is the default on ``cpu``, so CPU users get interpret mode only
when they ask for ``pallas``.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax
import numpy as np

PLATFORMS = ("gpu", "cpu")
BACKENDS = ("xla", "packed", "pallas")


def platform() -> str:
    """``gpu`` or ``cpu``: the platform JAX runs this process on."""
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: this program runs on an "
            "NVIDIA GPU ('gpu') or on the host ('cpu')"
        )
    return p


def interpret(plat: Optional[str] = None) -> bool:
    """The ``interpret=`` flag of every Pallas call: True on ``cpu``
    (no card to compile for), False on ``gpu`` — there a kernel that
    cannot compile raises; it never falls back to the interpreter."""
    plat = plat or platform()
    if plat not in PLATFORMS:
        raise RuntimeError(f"unsupported platform {plat!r}")
    return plat == "cpu"


def default_backend(plat: Optional[str] = None) -> str:
    return "pallas" if (plat or platform()) == "gpu" else "packed"


class Route(NamedTuple):
    """The chosen scan path for one program.

    ``backend`` is the plain path that serves every primitive without a
    kernel (``xla`` or ``packed``), or ``pallas`` when the word kernel
    serves the match statistics. ``kernel`` names the scanner that serves
    the match statistics: ``word`` (Pallas-Triton), ``count`` (run-length
    ``lax.scan``, ops.scan_count) or None. ``device_spans``: span
    enumeration runs as one device program (scan_xla.spans_rounds)
    instead of host-driven rounds."""

    backend: str
    kernel: Optional[str]
    device_spans: bool


def route(
    prog,
    backend: Optional[str] = None,
    *,
    accept_map=None,
    P: int = 1,
    plat: Optional[str] = None,
) -> Route:
    """Scan path for ``prog``: the requested backend (argument, then
    ``RrxConfig.backend`` / ``RRX_BACKEND``), else the platform default,
    resolved against what the program supports."""
    from .ops.scan_count import counting_plan
    from .ops.scan_word import word_spec
    from .utils.config import get_config

    req = backend or get_config().backend or default_backend(plat)
    if req not in BACKENDS:
        raise ValueError(
            f"unknown backend {req!r}; expected one of {BACKENDS}"
        )
    plain = "xla" if (req == "xla" or prog.tier == "sparse") else "packed"
    if req != "pallas":
        return Route(plain, None, False)
    if (
        accept_map is None
        and P == 1
        and prog.G <= 1
        and counting_plan(prog) is not None
    ):
        # one-record-per-row tiers: the lanes^2 follow matmul loses to
        # one int32 run counter per record
        return Route(plain, "count", True)
    if (
        prog.tier != "sparse"
        and word_spec(prog, accept_map=_np(accept_map), P=P) is not None
    ):
        return Route("pallas", "word", True)
    return Route(plain, None, True)


def _np(a):
    return None if a is None else np.asarray(a)


def ensure_compile_cache() -> None:
    """Persistent compilation cache: where ``JAX_COMPILATION_CACHE_DIR``
    (or the caller) says — JAX reads the variable itself, so nothing is
    set then — else the fixed ``.jax_cache/`` directory of the checkout."""
    if (
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or jax.config.jax_compilation_cache_dir
    ):
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update(
        "jax_compilation_cache_dir", os.path.join(root, ".jax_cache")
    )
