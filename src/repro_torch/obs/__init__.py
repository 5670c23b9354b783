"""Observability of the port (DESIGN.md §15): tracing, metrics, kernel
build and launch accounting.

- ``obs.trace``     — structured spans, grown from the JAX package's
  ``obs/trace.py``: deterministic ids for the serving tier, and a
  collecting sink (``trace.collect``) that gathers the spans recorded
  inside one job (factorize, each Gen-DST generation, each AutoML rung).
- ``obs.metrics``   — a copy of its ``obs/metrics.py`` (counters, gauges,
  histograms, Prometheus text, bit-identical state round trip).
- ``obs.torchprof`` — the counterpart of its ``obs/jaxprof.py``: kernel
  builds per source and launches per kernel where JAX counts jit tracings,
  padded-vs-useful FLOPs of megabatch packs, an opt-in dispatch hook.

None of them opens a ``torch.profiler`` range: a profiler shows such a
range on the device's timeline too, where it would read as device work.
"""
from . import metrics, torchprof, trace

__all__ = ["metrics", "torchprof", "trace"]
