"""The program's own spans of the window's jobs, for the per-layer readers.

A job's spans are its record's ``spans`` (in the ``substrat.*`` cells
``execute``'s sink: the four phase spans and every span the layers below
record under them) and its AutoML result's ``spans`` (``AutoMLResult.spans``,
in the ``automl.*`` cells), each counted once.  Where the program records
no span of a kind, as a program older than those spans does, a reader gets
None, never an error.
"""
from __future__ import annotations

import bisect
from typing import List, Optional

import numpy as np


def job_spans(record: dict) -> List[dict]:
    """Every span of one job's record, once.  Today the two lists share no
    span; an ``automl_fit`` entry that also hands its result's spans to the
    harness in ``record["spans"]`` (to label its idle gaps) would repeat
    them, and they still count once."""
    found = list(record.get("spans") or ())
    found += list(getattr(record.get("result"), "spans", None) or ())
    seen, out = set(), []
    for sp in found:
        key = (sp.get("trace_id"), sp["span_id"]) if "span_id" in sp else id(sp)
        if key not in seen:
            seen.add(key)
            out.append(sp)
    return out


def per_job(run, *names: str) -> Optional[List[List[dict]]]:
    """Each window job's spans of the kinds ``names``; None where no job
    has one."""
    jobs = [[sp for sp in job_spans(jb["record"]) if sp["name"] in names] for jb in run.jobs]
    return jobs if any(jobs) else None


def seconds_per_job(run, *names: str) -> Optional[float]:
    """Mean over the window's jobs of the seconds their spans of the kinds
    ``names`` cover, summed within a job."""
    jobs = per_job(run, *names)
    if jobs is None:
        return None
    return float(np.mean([sum(sp["t1"] - sp["t0"] for sp in job) for job in jobs]))


def mean_seconds(run, name: str) -> Optional[float]:
    """Mean seconds of one span of the kind ``name`` over the window."""
    jobs = per_job(run, name)
    if jobs is None:
        return None
    return float(np.mean([sp["t1"] - sp["t0"] for job in jobs for sp in job]))


def attr_per_job(run, key: str) -> Optional[List[float]]:
    """Each window job's sum of the span attribute ``key``; None where no
    span carries it."""
    jobs = [[sp["attrs"][key] for sp in job_spans(jb["record"]) if key in sp.get("attrs", {})]
            for jb in run.jobs]
    return [float(sum(v)) for v in jobs] if any(jobs) else None


def ops_per_span(stretch, name: str) -> Optional[float]:
    """Device operations of the traced stretch that start inside a span of
    the kind ``name`` (spans of one kind do not overlap), over the number of
    such spans; None without a trace or such spans."""
    if stretch is None:
        return None
    spans = sorted((s, e) for n, s, e in stretch.spans_ns if n == name)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    inside = 0
    for _, s, _e in stretch.ops:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            inside += 1
    return inside / len(spans)
