"""Nothing the benchmark runs may load JAX or the JAX package.

Names are compared by their top-level part (before the first dot), whole:
`repro_torch` is the program, `repro` the JAX package it was ported from.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def check_isolation() -> None:
    """Exit without a result if a forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"gpbench: forbidden modules loaded in this process: {found}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
