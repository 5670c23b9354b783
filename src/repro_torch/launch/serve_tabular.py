"""Serving walkthrough of the port: the multi-tenant SubStrat job server, in
one process or across worker processes (after the JAX package's
``examples/serve_tabular.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_tabular [--jobs 4] [--scale 0.3]
        [--trials 8] [--workers 2] [--kill-worker 0] [--kill-task 0]
        [--json out.json] [--device cuda]

Submits ``--jobs`` AutoML jobs in same-dataset pairs over two tabular
datasets (D3, D6) from two tenants, so every odd job is a repeat
submission; job ``i`` carries seed ``i``.  Drives the scheduler and prints
what the service did for each job: which phases ran, which the DST cache
skipped, how rung cohorts merged, the per-tenant accounting and a budget
rejection.

With ``--workers N`` the rung evaluations ship over the wire format to
``N`` worker processes on ``--device`` (several share one card); the subset
search stays in this process.  ``--kill-worker W [--kill-task T]`` makes
worker ``W`` exit hard when it dequeues its ``T``-th task: the front end
re-dispatches its cohorts to the survivors and still gives the fault-free
answer.  ``--json PATH`` writes per-job results (winner family, test
accuracy, trial accuracies) and the transport counters, so a chaos run can
be diffed against a fault-free one.  Every run ends with one job's span
timeline (the job whose killed task was retried, on chaos runs) and the
metrics exposition.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..automl.engine import AutoMLConfig
from ..core.gen_dst import GenDSTConfig
from ..core.plan import plan
from ..data.tabular import PAPER_DATASETS, make_dataset, train_test_split
from ..device import resolve_device
from ..obs.trace import render_timeline
from ..service import (
    BudgetExceeded, DistributedScheduler, ProcessWorkerPool, SubStratServer,
)

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=4,
                    help="submissions, paired over 2 datasets (odd jobs are "
                         "repeats of the preceding even job's dataset)")
    ap.add_argument("--scale", type=float, default=0.3,
                    help="dataset row-count scale (0.1 = smoke size)")
    ap.add_argument("--trials", type=int, default=8,
                    help="AutoML trial budget of the sub pass")
    ap.add_argument("--workers", type=int, default=0,
                    help="run rung evaluation on N worker processes "
                         "(0 = in-process scheduler, the default)")
    ap.add_argument("--kill-worker", type=int, default=None, metavar="W",
                    help="chaos: worker W exits hard when it dequeues its "
                         "--kill-task'th task (requires --workers)")
    ap.add_argument("--kill-task", type=int, default=0, metavar="T",
                    help="which dequeue of worker W triggers the kill "
                         "(default 0 = its first task)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write per-job results + transport stats as JSON")
    ap.add_argument("--device", default="cuda",
                    help="device of the front end and the workers")
    args = ap.parse_args(argv)
    if args.kill_worker is not None and args.workers <= 0:
        ap.error("--kill-worker requires --workers >= 1")
    dev = resolve_device(args.device)

    datasets = []
    for name in ("D3", "D6"):
        X, y = make_dataset(PAPER_DATASETS[name], scale=args.scale)
        Xtr, ytr, Xte, yte = train_test_split(X, y)
        datasets.append((name, Xtr, ytr, Xte, yte))

    p = plan(
        "gen_dst", cfg=GenDSTConfig(psi=8, phi=20),
        sub_automl=AutoMLConfig(n_trials=args.trials, rungs=(30, 80)),
        ft_automl=AutoMLConfig(n_trials=4, rungs=(80,)),
    )

    if args.workers > 0:
        # fault events are primitive tuples (worker, task, action, seconds),
        # what the tests' FaultPlan compiles to
        events = ()
        if args.kill_worker is not None:
            events = ((args.kill_worker, args.kill_task, "kill", 0.0),)
            print(f"chaos: worker {args.kill_worker} will exit at its "
                  f"task #{args.kill_task}")
        print(f"starting {args.workers} worker process(es) on {dev}...", flush=True)
        pool = ProcessWorkerPool(args.workers, device=dev, fault_events=events)
        print("worker boot s: " + ", ".join(f"{w} {s:.2f}"
                                             for w, s in sorted(pool.boot_s.items())))
        srv = SubStratServer(scheduler=DistributedScheduler(
            pool, stall_timeout_s=120.0, device=dev))
    else:
        srv = SubStratServer(device=dev)

    ids = []
    for i in range(args.jobs):
        name, Xtr, ytr, Xte, yte = datasets[(i // 2) % len(datasets)]
        tenant = "acme" if i % 2 == 0 else "globex"
        jid = srv.submit(Xtr, ytr, tenant=tenant, seed=i, plan=p,
                         X_test=Xte, y_test=yte)
        ids.append((jid, name))
        print(f"submitted job {jid} ({name}, tenant {tenant})")

    try:
        srv.run()

        print("\njob  dataset  phase  dst      sub-automl  result")
        records = []
        for jid, name in ids:
            st = srv.poll(jid)
            res = srv.result(jid)
            dst = ("cache-hit" if st.cache_hit else
                   f"{st.times['gen_dst_s']:.2f}s")
            sub = ("warm-start" if st.warm_started else
                   f"{st.times.get('automl_sub_s', 0.0):.2f}s")
            print(f"{jid:>3}  {name:>7}  {st.phase:>5}  {dst:>8}  {sub:>10}  "
                  f"{res.final.spec.family}, test-acc "
                  f"{res.final.test_acc:.3f}, {res.total_time_s:.2f}s")
            records.append({
                "job": jid, "dataset": name,
                "family": res.final.spec.family,
                "preproc": res.final.spec.preproc,
                "test_acc": float(res.final.test_acc),
                "trials": [float(v) for _, v in res.final.trials],
                "sub_trials": [float(v) for _, v in res.intermediate.trials],
            })

        stats = srv.stats()
        print(f"\ncache: {stats['cache']['hits']} hits / "
              f"{stats['cache']['misses']} misses, {stats['cache']['size']} DSTs")
        print(f"rung dispatches: {stats['merged_rungs']} merged "
              f"(covering {stats['merged_jobs']} job-rungs, "
              f"{stats['hetero_rungs']} shape-padded), "
              f"{stats['solo_rungs']} solo")
        if "transport" in stats:
            tr = stats["transport"]
            print(f"transport: {tr['remote_tasks']} remote tasks, "
                  f"{tr['worker_failures']} worker failures, "
                  f"{tr['redispatched_tasks']} re-dispatched, "
                  f"{tr['workers_alive']}/{tr['workers_total']} workers alive")
        for tenant, acc in stats["tenants"].items():
            print(f"tenant {tenant}: {acc['jobs_submitted']} jobs, "
                  f"{acc['spent_s']:.2f}s compute")

        # trace timeline: prefer a job with a visible retry span (chaos runs)
        tl_jid = ids[0][0]
        for jid, _ in ids:
            tr = srv.trace(jid)
            if tr and any(s.get("attempt", 0) > 0 for s in tr["spans"]):
                tl_jid = jid
                break
        tr = srv.trace(tl_jid)
        print(f"\ntrace timeline (job {tl_jid}, trace {tr['trace_id']}):")
        print(render_timeline(tr["spans"]))

        print("\n/v1/metrics exposition:")
        print(srv.metrics_text())

        payload = {"jobs": records, "transport": stats.get("transport")}
        if args.json:
            Path(args.json).write_text(json.dumps(payload, indent=2))
            print(f"wrote {args.json}")
    finally:
        if hasattr(srv.scheduler, "close"):
            srv.scheduler.close()

    # budget accounting: a tenant over its budget is refused at submit
    srv.set_budget("acme", 1e-6)
    _, Xtr, ytr, *_ = datasets[0]
    try:
        srv.submit(Xtr, ytr, tenant="acme", plan=p)
    except BudgetExceeded as e:
        print(f"\nbudget rejection works: {e}")
    return payload


if __name__ == "__main__":
    main()
