"""roaringregex -- a GPU regex / string-scanning framework in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
RoaringRegex reference engine (POSIX-ERE, Thompson/Glushkov NFA simulation
with tiered state-set representations):

* host compiler: POSIX-ERE -> epsilon-free Glushkov position NFA whose
  transition factorizes as ``delta(D, c) = follow(D) & B[c]``;
* device scan: the per-byte step runs as a Pallas-Triton word kernel (one
  ``uint32`` state set per record, automata of up to 32 states) or as
  batched 0/1 matrix products (dense 128- and 256-state tiers plus a
  block-sparse follow-matrix tier for pathological automata), chosen in
  one place (``platform.route``);
* distributed: corpora shard data-parallel over a device mesh, tables are
  replicated, match statistics reduce with psum.

See SURVEY.md for the structural analysis of the reference and PERF.md for
measurements.
"""

from .api import Match, MultiPattern, Pattern, compile  # noqa: F401
from .compiler.nfa import NFA, build_nfa  # noqa: F401
from .compiler.program import DeviceProgram, compile_program  # noqa: F401
from .compiler.parser import RegexSyntaxError, parse  # noqa: F401
from .compiler.serialize import (  # noqa: F401
    cached_compile,
    load_program,
    save_program,
)
from .oracle.engine import OracleEngine  # noqa: F401

__version__ = "0.1.0"
