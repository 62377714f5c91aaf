"""Framework configuration (SURVEY.md §5 "config/flag system" row).

The reference hard-codes every constant (tier cut-offs Parser.cpp:165-168,
0x80 alphabet bound NFA.cc:25, arena rows regex.h:34) and its README
complains they aren't tweakable (README.md:57). Here the knobs live in one
dataclass, overridable programmatically (``set_config``) or via environment
variables (``RRX_*``) so multi-host launches configure workers uniformly.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Optional


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


@dataclass(frozen=True)
class RrxConfig:
    # backend: None = the platform default (platform.route: pallas on the
    # GPU, packed on the CPU); xla / packed / pallas force a path
    backend: Optional[str] = field(
        default_factory=lambda: os.environ.get("RRX_BACKEND") or None
    )
    # compiled-program cache directory (content-addressed .npz)
    cache_dir: Optional[str] = field(
        default_factory=lambda: os.environ.get("RRX_CACHE_DIR") or None
    )
    # largest state count with fully dense device tables (tier cut-off)
    dense_max: int = field(default_factory=lambda: _env_int("RRX_DENSE_MAX", 1024))
    # long-string mode block length
    long_block: int = field(default_factory=lambda: _env_int("RRX_LONG_BLOCK", 4096))
    # windowed batch scan on the word kernel: split long records into
    # overlapped windows until the batch is ~this many records wide
    # (exact for bounded-horizon anchor-free non-nullable patterns;
    # engine._window_plan). 0 (default) = off: not measured on the GPU.
    window_cols: int = field(
        default_factory=lambda: _env_int("RRX_WINDOW_COLS", 0)
    )
    # seeded-alias rewrite for whole-pattern X{m,n} on the big-automaton
    # tiers (engine._seeded_alias: the upper bound is unobservable under
    # seeded semantics, so X{m,n} scans as X{m,}); RRX_ALIAS=0 keeps the
    # original automaton on every path
    seeded_alias: bool = field(
        default_factory=lambda: os.environ.get("RRX_ALIAS", "1") != "0"
    )
    # hyperscan-style prefilter for the >1024-state tier: scan a tiny
    # superset-language program first and run the full scan only on
    # compacted candidate records (engine.relaxed_prefilter_program)
    sparse_prefilter: bool = field(
        default_factory=lambda: os.environ.get("RRX_SPARSE_PREFILTER", "1")
        != "0"
    )
    # native host runtime (C++ compiler/packer) on/off
    native: bool = field(
        default_factory=lambda: os.environ.get("RRX_NATIVE", "1") != "0"
    )

    def with_(self, **kw) -> "RrxConfig":
        return replace(self, **kw)


_config: RrxConfig = RrxConfig()


def get_config() -> RrxConfig:
    return _config


def set_config(cfg: RrxConfig) -> RrxConfig:
    global _config
    _config = cfg
    return _config
