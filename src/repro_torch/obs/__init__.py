"""Observability of the port: a copy of the JAX package's ``obs/trace.py``
(structured spans).  The rest of ``obs/`` is not ported yet."""
from . import trace

__all__ = ["trace"]
