"""Structured tracing for the serving stack (DESIGN.md §15.1).

A copy of the JAX package's ``obs/trace.py`` (stdlib only); ``core/plan.py``
records its phase spans through it.

A span is a plain dict — wire- and JSON-safe by construction, so spans
cross process boundaries (worker results), checkpoints (scheduler
snapshots), and HTTP (``/v1/trace``) without a codec of their own::

    {"trace_id": ..., "span_id": ..., "parent_id": ..., "name": ...,
     "attempt": 0, "t0": <unix s>, "t1": <unix s>, "attrs": {...}}

**Deterministic ids.**  ``span_id(trace_id, name, attempt)`` is a pure
hash: both ends of a dispatch derive the *same* id for the same logical
span without exchanging it.  The front end ships only
``{"trace_id", "attempt"}`` in the wire header plus the attempt number in
the task message; the worker re-derives its parent dispatch-span id from
those — which is what lets a re-dispatched (retried) task's worker spans
land under the retry's dispatch span rather than the first attempt's.

**Current span.**  A contextvar tracks the innermost open span so nested
``span(...)`` blocks parent automatically; cross-thread/process parents
are passed explicitly (``parent_id=``).

Timestamps are wall-clock (``time.time()``): worker and front-end spans
from the same machine line up on one timeline, which is how
``render_timeline`` shows queue-wait next to remote evaluation.
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
import time
from typing import Dict, Iterable, List, Optional

__all__ = ["child_ctx", "current_span", "job_trace_id", "make_span",
           "render_timeline", "span", "span_id"]

_CURRENT: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "substrat_current_span", default=None)


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
def span(sink: Optional[List[dict]], trace_id: str, name: str, *,
         attempt: int = 0, parent_id: Optional[str] = None, **attrs):
    """Open a span; on exit, close it and append to ``sink``.

    The parent defaults to the contextvar current span (same-context
    nesting); pass ``parent_id=`` explicitly when the parent lives in
    another process (the wire-propagated dispatch span).  The open span
    dict is yielded so callers can add attrs mid-flight."""
    if parent_id is None:
        parent = _CURRENT.get()
        parent_id = parent["span_id"] if parent is not None else None
    sp = make_span(trace_id, name, time.time(), 0.0,
                   parent_id=parent_id, attempt=attempt, attrs=attrs)
    token = _CURRENT.set(sp)
    try:
        yield sp
    except BaseException:
        sp["attrs"]["error"] = True
        raise
    finally:
        sp["t1"] = time.time()
        _CURRENT.reset(token)
        if sink is not None:
            sink.append(sp)


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
        for k in ("phase", "rung", "worker", "outcome", "mode"):
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
