"""The modules a run of the port's benchmark must never have loaded."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_loaded"]

# the JAX stack, the JAX package and its CPU benchmark harness, by
# top-level name compared whole ("repro_torch" is not "repro")
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
