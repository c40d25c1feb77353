"""The check that the run loaded nothing of the JAX package.

The port's package is named ``repro_torch``; the JAX package ``repro``.
Names are compared by their whole top-level part (before the first
dot), so ``repro_torch`` never reads as ``repro``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the
    modules loaded in this process), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
