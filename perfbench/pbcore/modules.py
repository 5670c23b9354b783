"""The check that a run loaded neither JAX nor the JAX package.

A module's top-level name (the part before the first dot) is compared whole
with each forbidden name: ``repro_torch``, the port, passes, and ``repro``,
the JAX package, fails.
"""
from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among the module names ``names``."""
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops.intersection(FORBIDDEN))
