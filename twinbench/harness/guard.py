"""What a run may not load: JAX, its libraries and the JAX package
(``repro``), compared by whole top-level module names, so the port,
``repro_torch``, passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
