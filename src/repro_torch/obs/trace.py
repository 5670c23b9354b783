"""Structured tracing for the serving stack and the one-shot job (DESIGN.md §15.1).

Grown from the JAX package's ``obs/trace.py`` (stdlib only): the span
record, ``make_span``, ``span_id``, ``child_ctx`` and ``render_timeline``
are its; the collecting sink (``collect``) and the ids of collected spans
are the port's own.

A span is a plain dict — wire- and JSON-safe by construction, so spans
cross process boundaries (worker results), checkpoints (scheduler
snapshots), and HTTP (``/v1/trace``) without a codec of their own::

    {"trace_id": ..., "span_id": ..., "parent_id": ..., "name": ...,
     "attempt": 0, "t0": <unix s>, "t1": <unix s>, "attrs": {...}}

``name`` is the kind of work (readers group by it); what tells two spans
of one kind apart (a generation, a rung) goes in ``attrs``.

**Two ways to record.**

- *An explicit sink*: ``span(sink, trace_id, name, ...)`` appends the
  closed span to ``sink``.  Its id is ``span_id(trace_id, name, attempt)``,
  a pure hash: both ends of a dispatch derive the *same* id for the same
  logical span without exchanging it.  The front end ships only
  ``{"trace_id", "attempt"}`` in the wire header plus the attempt number in
  the task message; the worker re-derives its parent dispatch-span id from
  those — which is what lets a re-dispatched (retried) task's worker spans
  land under the retry's dispatch span rather than the first attempt's.
- *A collecting sink*: inside ``with collect(sink):``, ``span(None, None,
  name)`` appends to ``sink`` (and to the sink of every enclosing
  ``collect``), under the collect's trace id.  Code deep in a job records
  its spans this way without a parameter of its own.  Outside any
  ``collect`` such a span records nothing and sets no current span; it
  still stamps ``t0``/``t1`` on the record it yields, so a caller can read
  its extent.  A collected span's id is derived from its parent's id (the
  trace id for a root), its name, its attempt and how many same-named
  siblings opened before it, so ids are unique within a trace however
  often a kind repeats.  An explicit sink is never inherited: a span only
  lands in a sink it was given or in the sink of an open ``collect``.

**Current span.**  A contextvar tracks the innermost open recorded span so
nested ``span(...)`` blocks parent automatically; cross-thread/process
parents are passed explicitly (``parent_id=``).

Timestamps are wall-clock (``time.time()``): worker and front-end spans
from the same machine line up on one timeline, which is how
``render_timeline`` shows queue-wait next to remote evaluation.
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

__all__ = ["child_ctx", "collect", "current_span", "job_trace_id", "make_span",
           "render_timeline", "span", "span_id"]

_CURRENT: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "substrat_current_span", default=None)


class _Collector(NamedTuple):
    sinks: tuple        # this collect's sink, then the enclosing ones'
    trace_id: str
    opened: dict        # (parent_id, name, attempt) -> spans opened so far


_COLLECT: contextvars.ContextVar[Optional[_Collector]] = contextvars.ContextVar(
    "substrat_collecting_sink", default=None)


def _digest(text: str) -> str:
    return hashlib.blake2s(text.encode("utf-8"), digest_size=8).hexdigest()


def job_trace_id(job_id: int) -> str:
    """Deterministic trace id of one served job."""
    return _digest(f"substrat-job/{int(job_id)}")


def span_id(trace_id: str, name: str, attempt: int = 0) -> str:
    """Deterministic span id — a pure function of (trace, name, attempt).

    The serving tier derives names from ``(job_id, phase, ...)``, so the
    same logical unit of work gets the same id on every run and on both
    sides of a process boundary (no id exchange needed)."""
    return _digest(f"{trace_id}/{name}#{int(attempt)}")


def current_span() -> Optional[dict]:
    """The innermost open span of this context, or None."""
    return _CURRENT.get()


def make_span(trace_id: str, name: str, t0: float, t1: float, *,
              parent_id: Optional[str] = None, attempt: int = 0,
              attrs: Optional[dict] = None) -> dict:
    """Build a closed span record without entering a context."""
    return {
        "trace_id": trace_id,
        "span_id": span_id(trace_id, name, attempt),
        "parent_id": parent_id,
        "name": name,
        "attempt": int(attempt),
        "t0": float(t0),
        "t1": float(t1),
        "attrs": dict(attrs or {}),
    }


@contextlib.contextmanager
def collect(sink: List[dict]):
    """Collect the spans opened with ``span(None, ...)`` in this context
    into ``sink`` (closed spans, innermost first).  The outermost collect
    opens a trace of its own, under a fresh random id; a nested collect
    joins the enclosing one's trace and also feeds its sinks."""
    outer = _COLLECT.get()
    if outer is None:
        col = _Collector((sink,), os.urandom(8).hex(), {})
    else:
        col = _Collector((sink,) + outer.sinks, outer.trace_id, outer.opened)
    token = _COLLECT.set(col)
    try:
        yield sink
    finally:
        _COLLECT.reset(token)


class _Open:
    """The context manager ``span`` returns; yields the span record."""
    __slots__ = ("rec", "sinks", "token")

    def __init__(self, rec: dict, sinks: tuple):
        self.rec, self.sinks, self.token = rec, sinks, None

    def __enter__(self) -> dict:
        self.rec["t0"] = time.time()
        if self.sinks:
            self.token = _CURRENT.set(self.rec)
        return self.rec

    def __exit__(self, exc_type, exc, tb) -> bool:
        rec = self.rec
        rec["t1"] = time.time()
        if self.sinks:
            if exc_type is not None:
                rec["attrs"]["error"] = True
            _CURRENT.reset(self.token)
            for sink in self.sinks:
                sink.append(rec)
        return False


def span(sink: Optional[List[dict]], trace_id: Optional[str], name: str, *,
         attempt: int = 0, parent_id: Optional[str] = None, **attrs) -> _Open:
    """Open a span (``with span(...) as sp:``); on exit, close it and
    append it to ``sink``, or, with ``sink=None``, to the collecting sinks
    (``collect``; nothing outside one, module docstring).

    The parent defaults to the contextvar current span (same-context
    nesting); pass ``parent_id=`` explicitly when the parent lives in
    another process (the wire-propagated dispatch span).  A collected span
    takes the collect's trace id (pass ``trace_id=None``).  The open span
    dict is yielded so callers can add attrs mid-flight."""
    if sink is not None:
        sinks, col = (sink,), None
    else:
        col = _COLLECT.get()
        if col is None:
            return _Open({"name": name, "t0": 0.0, "t1": 0.0, "attrs": attrs}, ())
        sinks, trace_id = col.sinks, col.trace_id
    if parent_id is None:
        parent = _CURRENT.get()
        parent_id = parent["span_id"] if parent is not None else None
    if col is None:
        sid = span_id(trace_id, name, attempt)
    else:
        key = (parent_id, name, int(attempt))
        k = col.opened.get(key, 0)
        col.opened[key] = k + 1
        sid = _digest(f"{parent_id or trace_id}/{name}#{int(attempt)}.{k}")
    rec = {"trace_id": trace_id, "span_id": sid, "parent_id": parent_id, "name": name,
           "attempt": int(attempt), "t0": 0.0, "t1": 0.0, "attrs": attrs}
    return _Open(rec, sinks)


def child_ctx(trace_id: str, parent_name: str, attempt: int = 0) -> dict:
    """The propagation payload a wire header carries (DESIGN.md §15.2):
    enough for the remote end to re-derive its parent span id."""
    return {"trace_id": trace_id, "parent": parent_name,
            "attempt": int(attempt)}


def _tree(spans: Iterable[dict]):
    """(roots, children-by-parent) with deterministic t0-then-name order."""
    spans = sorted(spans, key=lambda s: (s["t0"], s["name"]))
    ids = {s["span_id"] for s in spans}
    kids: Dict[str, List[dict]] = {}
    roots = []
    for s in spans:
        p = s.get("parent_id")
        if p is not None and p in ids:
            kids.setdefault(p, []).append(s)
        else:
            roots.append(s)
    return roots, kids


def render_timeline(spans: Iterable[dict], width: int = 32) -> str:
    """ASCII per-trace timeline: nested spans with offset/duration bars.

    Offsets are relative to the earliest span start; the bar column scales
    to the whole trace, so queue-wait, retries, and worker-side work show
    up as visibly disjoint segments of one timeline."""
    spans = list(spans)
    if not spans:
        return "(no spans)"
    t_lo = min(s["t0"] for s in spans)
    t_hi = max(max(s["t1"], s["t0"]) for s in spans)
    total = max(t_hi - t_lo, 1e-9)
    roots, kids = _tree(spans)
    lines = []

    def emit(s, depth):
        lo = int(round((s["t0"] - t_lo) / total * (width - 1)))
        hi = int(round((max(s["t1"], s["t0"]) - t_lo) / total * (width - 1)))
        bar = " " * lo + "#" * max(hi - lo, 1)
        label = "  " * depth + s["name"]
        if s.get("attempt"):
            label += f" (retry #{s['attempt']})"
        extra = []
        for k in ("phase", "rung", "gen", "worker", "outcome", "mode"):
            if k in s["attrs"]:
                extra.append(f"{k}={s['attrs'][k]}")
        lines.append(
            f"{label:<34} |{bar:<{width}}| "
            f"+{s['t0'] - t_lo:7.3f}s {s['t1'] - s['t0']:8.3f}s"
            + (f"  {' '.join(extra)}" if extra else ""))
        for c in kids.get(s["span_id"], ()):
            emit(c, depth + 1)

    for r in roots:
        emit(r, 0)
    return "\n".join(lines)
