"""One run of one cell: set-up, the measured window, the traced stretch, and
the check of the window's answers against the reference.

The loop is closed with one client: jobs run back to back until the window's
seconds have passed, the last job finishing.  ``job_s`` is the window's
seconds over the jobs it completed; ``test_acc`` the mean test accuracy of
their final models.  Set-up pays everything a deployment pays once per
process: import, CUDA, the kernels' build or load, the table, and one
untimed job at the cell's shapes.
"""
from __future__ import annotations

import math
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from . import compare, tables
from .spec import Cell

# jobs of a run whose answers are checked, drawn from the seed
CHECKED_JOBS = 6
# the traced stretch: at least this many jobs and seconds under the profiler
PROFILED_JOBS, PROFILED_SECONDS = 2, 2.0


class Run:
    """What a run measured; the per-layer readers read it."""

    def __init__(self, cell: Cell, entry, table, inputs, device):
        self.cell, self.entry, self.table, self.device = cell, entry, table, device
        self.config, self.mix = cell.config, cell.mix
        self._inputs = inputs
        self.jobs: List[dict] = []          # the window's jobs
        self.window_s = 0.0
        self.stretch = None                 # profiling.Stretch of the traced run
        self._coded_meta = None

    def job_input(self, j: int):
        """(X, y, seed) of job ``j``."""
        return self._inputs(j)

    def table_bins(self) -> tuple:
        """(columns counting the target, histogram width) of the coded table."""
        if self._coded_meta is None:
            from . import reference as R
            codes, _, _, B = R.factorize(self.table.X_tr, self.table.y_tr)
            self._coded_meta = (codes.shape[1], B)
        return self._coded_meta


class Inputs:
    """Job inputs: the run's job ``j`` sends one entry of the mix's pool
    (``tables.pool_entry``); ``j = -1`` is the set-up's untimed job."""

    def __init__(self, table, mix: dict, run_seed: int):
        self.table, self.mix, self.seed, self._made = table, mix, run_seed, {}

    def _entry(self, j: int) -> int:
        return -1 if j < 0 else tables.pool_entry(self.mix, self.seed, j)

    def make(self, entry: int):
        perm, s = tables.pool_input(self.mix, entry, len(self.table.y_tr))
        return self.table.X_tr[perm], self.table.y_tr[perm], s

    def prepare(self):
        """Make every pool entry's input (set-up)."""
        for e in range(int(self.mix["job_pool"])):
            self._made[e] = self.make(e)

    def __call__(self, j: int):
        e = self._entry(j)
        return self._made[e] if e in self._made else self.make(e)

    def drop(self):
        self._made.clear()


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_process: float, log=print) -> dict:
    """Run ``cell`` once; returns the result line's fields and the comparison."""
    import torch
    dev = torch.device(device)
    table = tables.make_table(cell.mix)
    entry = cell.entry_module().Entry(cell.config, table, dev)
    inputs = Inputs(table, cell.mix, seed)
    X_te, y_te = table.X_te, table.y_te

    t0 = time.perf_counter()
    X, y, s = inputs(-1)
    entry.job(X, y, X_te, y_te, s, keep=False)
    _sync(torch, dev)
    warm_s = time.perf_counter() - t0
    n_sure = max(1, int(0.7 * seconds / warm_s))
    inputs.prepare()
    checked = tables.sample_jobs(cell.mix, seed, n_sure, CHECKED_JOBS)
    run = Run(cell, entry, table, inputs, dev)
    _sync(torch, dev)
    setup_s = time.time() - t_process
    log(f"set-up {setup_s:.3f} s (untimed job {warm_s:.3f} s); checking jobs {sorted(checked)}")

    attempted = failed = 0
    records: Dict[int, dict] = {}
    t_win = time.perf_counter()
    while True:
        X, y, s = inputs(attempted)
        t_job = time.perf_counter()
        try:
            rec = entry.job(X, y, X_te, y_te, s, keep=attempted in checked)
        except Exception:   # a job that fails counts as failed; the run goes on
            log(f"job {attempted} failed:\n{traceback.format_exc()}")
            failed += 1
            rec = None
        if rec is not None:
            rec["seconds"] = time.perf_counter() - t_job
            rec["job"] = attempted
            records[attempted] = rec
        attempted += 1
        if time.perf_counter() - t_win >= seconds:
            break
    _sync(torch, dev)
    run.window_s = time.perf_counter() - t_win
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run.jobs = [dict(job=j, seconds=r["seconds"], test_acc=entry.test_acc(r),
                     phase_s=entry.phase_seconds(r), record=r) for j, r in records.items()]
    done = len(run.jobs)
    e2e = {"setup_s": setup_s,
           "job_s": run.window_s / done if done else math.inf,
           "test_acc": float(np.mean([jb["test_acc"] for jb in run.jobs])) if done else 0.0}
    log(f"window {run.window_s:.3f} s: {attempted} jobs attempted, {done} done, "
        f"job_s {e2e['job_s']:.4f}, test_acc {e2e['test_acc']:.6f}; seconds of each job: "
        + " ".join(f"{jb['seconds']:.3f}" for jb in run.jobs))

    metrics, stretch_dev = {}, {}
    if trace:
        from .profiling import profile_jobs

        def one(j):
            X, y, s = inputs(j)
            return entry.job(X, y, X_te, y_te, s, keep=False)

        _, run.stretch = profile_jobs(torch, lambda: _sync(torch, dev), one, attempted,
                                      PROFILED_JOBS, PROFILED_SECONDS)
        stretch_dev = {"busy_s": run.stretch.busy_s, "window_s": run.stretch.window_s}
        for m, reader in cell.per_layer():
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}

    # the check: the sampled jobs' answers, once the window has closed and the
    # program's state is freed
    answers = {j: entry.answers(records[j]) for j in sorted(checked) if j in records}
    run.jobs = [dict(jb, record=None) for jb in run.jobs]
    records.clear()
    inputs.drop()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = []
    t_ref = time.perf_counter()
    for j, ans in answers.items():
        X, y, s = inputs(j)
        readings.append(entry.compare(X, y, X_te, y_te, s, ans, dev))
    correct, worst, fails = compare.verdict(readings, cell.limits)
    if failed:
        correct = False
    log(f"reference over {len(readings)} jobs {time.perf_counter() - t_ref:.3f} s")
    out = {
        "correct": bool(correct), "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {"memory_peak_bytes": int(peak), **stretch_dev},
        "checked": {k: [worst.get(k, math.nan), cell.limits.get(k, math.nan)]
                    for k in sorted(set(worst) | set(cell.limits))},
        "fails": fails,
    }
    if run.stretch is not None:
        out["breakdown"] = {"device_ops": run.stretch.top_ops(),
                            "idle_gaps": run.stretch.idle_gaps()}
    return out


def readings(cell: Cell, seeds, seconds: float, device: str, control: bool,
             jobs: Optional[int] = None, log=print) -> List[dict]:
    """For each seed: the jobs a run of ``seconds`` checks, run through the
    program back to back at the cell's load, then the numbers of the
    program's answers and, with ``control``, of the control's in the
    program's place.  ``jobs`` replaces the count a run would check."""
    import torch
    dev = torch.device(device)
    out = []
    for seed in seeds:
        table = tables.make_table(cell.mix)
        entry = cell.entry_module().Entry(cell.config, table, dev)
        inputs = Inputs(table, cell.mix, seed)
        t0 = time.perf_counter()
        X, y, s = inputs(-1)
        entry.job(X, y, table.X_te, table.y_te, s, keep=False)
        _sync(torch, dev)
        warm_s = time.perf_counter() - t0
        checked = sorted(tables.sample_jobs(cell.mix, seed, max(1, int(0.7 * seconds / warm_s)),
                                            jobs or CHECKED_JOBS))
        for j in checked:
            X, y, s = inputs(j)
            rec = entry.job(X, y, table.X_te, table.y_te, s, keep=True)
            ans = entry.answers(rec)
            del rec
            row = {"seed": seed, "job": j, "program": entry.compare(X, y, table.X_te, table.y_te,
                                                                    s, ans, dev)}
            if control:
                ctl = entry.control(X, y, table.X_te, table.y_te, s, ans, dev)
                row["control"] = entry.compare(X, y, table.X_te, table.y_te, s, ctl, dev)
            log(row)
            out.append(row)
    return out
