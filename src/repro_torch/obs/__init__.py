"""Observability of the port (DESIGN.md §15): tracing, metrics, kernel
build and launch accounting.

- ``obs.trace``     — a copy of the JAX package's ``obs/trace.py``
  (structured spans with deterministic ids).
- ``obs.metrics``   — a copy of its ``obs/metrics.py`` (counters, gauges,
  histograms, Prometheus text, bit-identical state round trip).
- ``obs.torchprof`` — the counterpart of its ``obs/jaxprof.py``: kernel
  builds per source and launches per kernel where JAX counts jit tracings,
  padded-vs-useful FLOPs of megabatch packs, an opt-in dispatch hook.
"""
from . import metrics, torchprof, trace

__all__ = ["metrics", "torchprof", "trace"]
