"""Diff two ``serve_tabular --json`` artifacts for result parity (after the
JAX package's ``examples/check_chaos_parity.py``).

    PYTHONPATH=src python -m repro_torch.launch.check_chaos_parity BASELINE.json CHAOS.json

The chaos gate: a run with ``--workers 2 --kill-worker 0`` must produce the
same winner family and preproc and the same trial accuracies (within 1e-6)
as the fault-free in-process run; crash recovery may cost time, never
answers.  When the second artifact ran on the cross-process tier, its
transport stats must also have seen the injected failure, so the gate
cannot pass because the kill never fired.  Pure JSON: no device.  A failed
check raises ``AssertionError``.
"""
from __future__ import annotations

import argparse
import json

__all__ = ["main"]


def _check(cond: bool, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline")
    ap.add_argument("chaos")
    args = ap.parse_args(argv)
    with open(args.baseline) as f:
        base = json.load(f)
    with open(args.chaos) as f:
        chaos = json.load(f)
    a, b = base["jobs"], chaos["jobs"]
    _check(len(a) == len(b), f"job count differs: {len(a)} vs {len(b)}")
    for ja, jb in zip(a, b):
        ctx = f"job {ja['job']} ({ja['dataset']})"
        _check(ja["family"] == jb["family"], f"{ctx}: family {ja['family']} vs {jb['family']}")
        _check(ja["preproc"] == jb["preproc"],
               f"{ctx}: preproc {ja['preproc']} vs {jb['preproc']}")
        _check(abs(ja["test_acc"] - jb["test_acc"]) <= 1e-6,
               f"{ctx}: test_acc {ja['test_acc']} vs {jb['test_acc']}")
        for kind in ("trials", "sub_trials"):
            _check(len(ja[kind]) == len(jb[kind]), f"{ctx}: {kind} length")
            for x, y in zip(ja[kind], jb[kind]):
                _check(abs(x - y) <= 1e-6, f"{ctx}: {kind} {x} vs {y}")
    tr = chaos.get("transport")
    if tr is not None and tr["workers_total"] > tr["workers_alive"]:
        _check(tr["worker_failures"] >= 1, tr)
        _check(tr["redispatched_tasks"] >= 1, tr)
        print(f"transport saw {tr['worker_failures']} worker failure(s), "
              f"{tr['redispatched_tasks']} re-dispatched task(s)")
    print(f"chaos parity OK: {len(a)} jobs identical within 1e-6")
    return 0


if __name__ == "__main__":
    main()
