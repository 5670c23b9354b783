"""Metrics registry (DESIGN.md §15.3): counters, gauges, histograms.

A copy of the JAX package's ``obs/metrics.py`` (stdlib only); the service
scheduler (``service/scheduler.py``) registers its families here.

Stdlib-only, with two export surfaces and one persistence surface:

- ``render()``   — Prometheus text exposition (version 0.0.4), served by
  ``GET /v1/metrics``;
- ``to_dict()``  — the in-process view (nested plain dicts) surfaced in
  ``stats()`` payloads;
- ``state_dict()`` / ``load_state()`` — a bit-identical round trip: the
  scheduler checkpoints its registry alongside jobs and spans, so a
  resumed front end reports continuous counters instead of rebooted ones.

Families are get-or-create: re-registering an existing name with the same
type returns the live family, which makes ``load_state`` + later
constructor registration idempotent (restore first, re-register after).

Label values are stored per-child keyed by the tuple of values in
declared label order; children materialize on first touch, so an
unexercised labelled family renders only its HELP/TYPE header.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "render_exposition_line"]

DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0, 300.0)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def render_exposition_line(name: str, labels: Sequence[Tuple[str, str]],
                           value: float) -> str:
    """One Prometheus sample line, labels rendered in declared order."""
    label_s = ""
    if labels:
        inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in labels)
        label_s = "{" + inner + "}"
    if isinstance(value, float) and value == int(value) and abs(value) < 1e15:
        return f"{name}{label_s} {int(value)}"
    return f"{name}{label_s} {value}"


class _Family:
    """Shared machinery: one metric name + label schema, many children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[k]) for k in self.label_names)

    # -- exports -------------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            if not self.label_names:
                return {"value": self._values.get((), 0.0)}
            return {"values": {",".join(k): v
                               for k, v in sorted(self._values.items())}}

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            if not self.label_names and () not in self._values:
                self._values[()] = 0.0   # label-less metrics always sample
            for key in sorted(self._values):
                lines.append(render_exposition_line(
                    self.name, list(zip(self.label_names, key)),
                    self._values[key]))
        return lines

    # -- persistence ---------------------------------------------------------

    def state(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "help": self.help,
                    "labels": list(self.label_names),
                    "values": sorted((list(k), v)
                                     for k, v in self._values.items())}

    def load(self, state: dict) -> None:
        with self._lock:
            self._values = {tuple(k): v for k, v in state["values"]}


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)


class Histogram(_Family):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per-child: [per-bucket counts..., +Inf count, sum]
        self._hv: Dict[Tuple[str, ...], List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            row = self._hv.setdefault(key, [0.0] * (len(self.buckets) + 2))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1.0
            row[-2] += 1.0          # +Inf / count
            row[-1] += float(value)  # sum

    def count(self, **labels) -> float:
        with self._lock:
            row = self._hv.get(self._key(labels))
            return row[-2] if row else 0.0

    def to_dict(self) -> dict:
        with self._lock:
            return {"buckets": list(self.buckets),
                    "series": {",".join(k): {"counts": row[:-1],
                                             "sum": row[-1]}
                               for k, row in sorted(self._hv.items())}}

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            items = sorted(self._hv.items()) or ([
                ((), [0.0] * (len(self.buckets) + 2))]
                if not self.label_names else [])
            for key, row in items:
                base = list(zip(self.label_names, key))
                cum = 0.0
                for i, b in enumerate(self.buckets):
                    cum = row[i]
                    lines.append(render_exposition_line(
                        f"{self.name}_bucket", base + [("le", repr(b))], cum))
                lines.append(render_exposition_line(
                    f"{self.name}_bucket", base + [("le", "+Inf")], row[-2]))
                lines.append(render_exposition_line(
                    f"{self.name}_sum", base, row[-1]))
                lines.append(render_exposition_line(
                    f"{self.name}_count", base, row[-2]))
        return lines

    def state(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "help": self.help,
                    "labels": list(self.label_names),
                    "buckets": list(self.buckets),
                    "values": sorted((list(k), list(row))
                                     for k, row in self._hv.items())}

    def load(self, state: dict) -> None:
        with self._lock:
            self.buckets = tuple(state["buckets"])
            self._hv = {tuple(k): list(row) for k, row in state["values"]}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """A named collection of metric families with deterministic export."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help: str, labels=(), **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind} with labels {fam.label_names}")
                return fam
            fam = cls(name, help, labels, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    # -- exports -------------------------------------------------------------

    def render(self) -> str:
        """The full Prometheus text exposition (families in name order)."""
        with self._lock:
            fams = [self._families[n] for n in sorted(self._families)]
        return "\n".join(line for f in fams for line in f.render()) + "\n"

    def to_dict(self) -> dict:
        with self._lock:
            fams = sorted(self._families.items())
        return {name: {"kind": f.kind, **f.to_dict()} for name, f in fams}

    # -- persistence (bit-identical round trip) ------------------------------

    def state_dict(self) -> dict:
        with self._lock:
            fams = sorted(self._families.items())
        return {name: f.state() for name, f in fams}

    def load_state(self, state: dict) -> None:
        """Replace the registry contents with ``state`` — families are
        recreated wholesale from their persisted schema, so
        ``state_dict()`` after a load is bit-identical to the source."""
        with self._lock:
            self._families.clear()
        for name, fs in state.items():
            cls = _KINDS[fs["kind"]]
            kw = {"buckets": fs["buckets"]} if fs["kind"] == "histogram" else {}
            fam = self._register(cls, name, fs["help"], fs["labels"], **kw)
            fam.load(fs)
