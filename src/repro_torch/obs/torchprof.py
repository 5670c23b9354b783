"""Kernel build and launch accounting (DESIGN.md §15.4).

The counterpart of the JAX package's ``obs/jaxprof.py``.  Four small
instruments, all process-global (the kernel libraries and their launch
counters are):

**Build counters.**  JAX counts jit tracings; the port traces nothing.  What
it compiles is its CUDA kernels: ``kernels/_build.py`` calls
``note_trace("<source stem>")`` once for every ``csrc/*.cu`` source that
``nvcc`` compiles (a library already built from the same sources is loaded,
not counted).  The counting API keeps the reference's names:
``tracing_snapshot()`` after warmup, ``new_tracings_since()`` after later
traffic, and an empty dict means nothing was built in between.  Since
``kernels/_build.library()`` keeps the library it loaded and the port
compiles nothing per shape, that gate holds the kernels to one build per
process and no more.

**Launch counters.**  Each kernel wrapper counts its own launches
(``kernels.launch_counts()``); the exposition carries them as
``kernel_launches_total{kernel=...}``.

**FLOP accounting.**  ``pack_flops(metas)`` prices one megabatch pack:
every trial costs the group-maximal padded shape at the group-maximal scan
length, its useful work is its own shape at its own step budget — the
absolute-FLOPs companion of the scheduler's relative ``merge_waste`` ratio,
built on ``launch/flops.py``'s analytic ``tabular_trial_flops``.

**Dispatch profile hook.**  Opt-in: ``set_dispatch_hook(fn)`` installs a
callable that receives ``(name, seconds, meta)`` after every scheduler
dispatch.  Torch has no counterpart of ``jax.monitoring``'s compile
events, so the reference's ``install_monitoring`` has none here.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence

from .metrics import render_exposition_line

__all__ = ["dispatch_event", "new_tracings_since", "note_trace", "pack_flops",
           "render_prometheus", "reset_tracing", "set_dispatch_hook", "total_tracings",
           "tracing_counts", "tracing_snapshot"]

_lock = threading.Lock()
_TRACE_COUNTS: Dict[str, int] = {}
_dispatch_hook: Optional[Callable] = None


# ---------------------------------------------------------------------------
# build counters
# ---------------------------------------------------------------------------


def note_trace(site: str) -> None:
    """Count one build of ``site`` (a kernel source's stem)."""
    with _lock:
        _TRACE_COUNTS[site] = _TRACE_COUNTS.get(site, 0) + 1


def tracing_counts() -> Dict[str, int]:
    """Per-site build counts since process start (or ``reset_tracing``)."""
    with _lock:
        return dict(_TRACE_COUNTS)


def total_tracings() -> int:
    with _lock:
        return sum(_TRACE_COUNTS.values())


def tracing_snapshot() -> Dict[str, int]:
    """Alias of ``tracing_counts`` named for the warmup/steady-state
    protocol: snapshot after warmup, diff after steady-state traffic."""
    return tracing_counts()


def new_tracings_since(snapshot: Dict[str, int]) -> Dict[str, int]:
    """Per-site builds that happened after ``snapshot`` was taken (empty
    dict == nothing was built since)."""
    now = tracing_counts()
    delta = {site: n - snapshot.get(site, 0) for site, n in now.items()}
    return {site: n for site, n in delta.items() if n > 0}


def reset_tracing() -> None:
    with _lock:
        _TRACE_COUNTS.clear()


# ---------------------------------------------------------------------------
# megabatch FLOP accounting
# ---------------------------------------------------------------------------


def pack_flops(metas: Sequence) -> tuple:
    """``(padded_flops, useful_flops)`` of one megabatch pack.

    ``metas`` are the scheduler's ``CohortMeta`` entries: ``shape =
    (N_tr, N_val, d, n_classes)`` plus per-trial ``steps``.  Padded cost
    prices every trial at the group-maximal shape and scan length (what
    the merged dispatch actually executes); useful cost is each trial's
    own shape and budget (what a solo run would have needed)."""
    from ..launch.flops import tabular_trial_flops
    ntr = max(m.shape[0] for m in metas)
    nval = max(m.shape[1] for m in metas)
    d = max(m.shape[2] for m in metas)
    c = max(m.shape[3] for m in metas)
    smax = max(max(m.steps) for m in metas)
    n_trials = sum(len(m.steps) for m in metas)
    padded = n_trials * tabular_trial_flops(ntr, nval, d, c, smax)
    useful = sum(
        tabular_trial_flops(m.shape[0], m.shape[1], m.shape[2], m.shape[3], st)
        for m in metas for st in m.steps)
    return float(padded), float(useful)


# ---------------------------------------------------------------------------
# per-dispatch profile hook (opt-in)
# ---------------------------------------------------------------------------


def set_dispatch_hook(fn: Optional[Callable]) -> None:
    """Install (or clear, with None) the per-dispatch profile callback:
    ``fn(name, seconds, meta)`` fires after every scheduler dispatch."""
    global _dispatch_hook
    _dispatch_hook = fn


def dispatch_event(name: str, seconds: float, **meta) -> None:
    """Report one finished dispatch to the opt-in hook (no-op otherwise)."""
    hook = _dispatch_hook
    if hook is not None:
        hook(name, seconds, meta)


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------


def render_prometheus() -> str:
    """Prometheus text block for the process-global build and launch
    counters — appended to the scheduler registry's exposition."""
    from ..kernels import launch_counts
    with _lock:
        builds = sorted(_TRACE_COUNTS.items())
    lines = [
        "# HELP torch_kernel_builds_total CUDA kernel builds per source "
        "(1 per nvcc compile)",
        "# TYPE torch_kernel_builds_total counter",
    ]
    lines.extend(render_exposition_line("torch_kernel_builds_total",
                                        [("site", site)], float(n))
                 for site, n in builds)
    if not builds:
        lines.append(render_exposition_line(
            "torch_kernel_builds_total", [("site", "none")], 0.0))
    lines.append("# HELP kernel_launches_total launches of each hand-written "
                 "CUDA kernel since its counter's last reset")
    lines.append("# TYPE kernel_launches_total counter")
    lines.extend(render_exposition_line("kernel_launches_total",
                                        [("kernel", k)], float(n))
                 for k, n in sorted(launch_counts().items()))
    return "\n".join(lines) + "\n"
