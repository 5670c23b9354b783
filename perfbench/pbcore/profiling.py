"""The device trace of a profiled stretch of jobs, reduced to numbers.

The device events (kernels, copies, fills) are read from
``torch.profiler``'s raw results, as ``chip_smoke.py``'s ``profile_share``
reads them (building the per-operator table takes far longer).  Busy time is
the union of the events' intervals; an idle gap is a stretch of the window
with none, labelled by the job's phase (a span of the program, or of the
entry adapter) open around its middle.  The spans are stamped with
``time.time()``; the profiler's clock is tied to it by a marker range the
harness opens at a known ``time.time()`` around each job (the profiler also
shows that range on the device's timeline: it is no device operation).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, List

MARK = "perfbench.job"


class Stretch:
    """What the trace of a profiled stretch shows."""

    def __init__(self, ops, window_ns, spans_ns, n_jobs: int):
        self.ops = ops                    # [(name, start_ns, end_ns)], by start
        self.window_ns = window_ns        # (start, end)
        self.spans_ns = spans_ns          # [(phase, start, end)]
        self.n_jobs = n_jobs

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def _merged(self):
        lo, hi = self.window_ns
        out = []
        for _, s, e in self.ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) / 1e9

    def phase_at(self, t_ns: float) -> str:
        for name, s, e in self.spans_ns:
            if s <= t_ns <= e:
                return name
        return "between_jobs"

    def idle_gaps(self, top: int = 10) -> List[list]:
        lo, hi = self.window_ns
        gaps, prev = [], lo
        for s, e in self._merged() + [[hi, hi]]:
            if s > prev:
                gaps.append((self.phase_at((s + prev) / 2), (s - prev) / 1e9))
            prev = max(prev, e)
        gaps.sort(key=lambda g: -g[1])
        return [[name, secs] for name, secs in gaps[:top]]

    def top_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for name, s, e in self.ops:
            by[name] += (e - s) / 1e9
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def kernel_times(self, key: str) -> List[float]:
        """Device seconds of each launch of the kernels whose name holds ``key``."""
        return [(e - s) / 1e9 for name, s, e in self.ops if key in name]

    def device_seconds_in(self, phase: str) -> float:
        """Device seconds of the operations that start inside ``phase``."""
        spans = sorted((s, e) for name, s, e in self.spans_ns if name == phase)
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e in self.ops:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= spans[i][1]:
                total += (e - s) / 1e9
        return total


def profile_jobs(torch, sync: Callable[[], None], run_job: Callable[[int], dict],
                 first_job: int, min_jobs: int, min_seconds: float) -> tuple:
    """Run jobs ``first_job``, ``first_job + 1``, ... under the profiler until
    ``min_jobs`` have run and ``min_seconds`` have passed; returns
    (records, Stretch)."""
    from torch.profiler import ProfilerActivity, profile
    recs, marks = [], []
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_start = time.time()
        j = first_job
        while len(recs) < min_jobs or time.time() - t_start < min_seconds:
            with torch.profiler.record_function(MARK):
                marks.append(time.time())
                recs.append(run_job(j))
            j += 1
        sync()
        t_end = time.time()
    ops, mark_ns = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name() == MARK:
            if e.device_type().name != "CUDA":
                mark_ns.append(e.start_ns())
        elif e.device_type().name == "CUDA":
            s = e.start_ns()
            ops.append((e.name(), s, s + e.duration_ns()))
    ops.sort(key=lambda o: o[1])
    mark_ns.sort()
    # the profiler's clock against time.time(), from the markers
    offsets = [m - t * 1e9 for m, t in zip(mark_ns, marks)]
    off = sorted(offsets)[len(offsets) // 2] if offsets else 0.0
    spans = [(sp["name"], sp["t0"] * 1e9 + off, sp["t1"] * 1e9 + off)
             for rec in recs for sp in rec["spans"]]
    return recs, Stretch(ops, (t_start * 1e9 + off, t_end * 1e9 + off), spans, len(recs))
