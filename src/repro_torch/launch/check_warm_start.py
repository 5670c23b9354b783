"""Gate for cross-tenant portfolio warm starts (after the JAX package's
``examples/check_warm_start.py``).

    PYTHONPATH=src python -m repro_torch.launch.check_warm_start [--device cuda]

Serves 4 history jobs cold on one scheduler, snapshots it, restores a fresh
scheduler from the snapshot (a server restart), and requires:

1. the experience store survives the snapshot bit-identically (wire bytes
   equal) and the restored store gives byte-for-byte the same portfolio
   decision as the live one;
2. the restarted, warm-started server reaches the cold baseline's winner
   accuracy on every new job in strictly fewer dispatched sub-AutoML trials;
3. its metrics text reports ``portfolio_hits_total`` equal to the jobs and
   a nonzero ``portfolio_trials_saved_total``.

Every scheduler runs on ``--device``.  Everything is seeded; a failed check
raises ``AssertionError``.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..automl.engine import AutoMLConfig
from ..core.measures import factorize
from ..core.plan import plan
from ..device import resolve_device
from ..meta import meta_features, portfolio_for
from ..service import SubStratServer, wire
from ..service.scheduler import Scheduler

__all__ = ["main"]


def _check(cond: bool, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def make_data(seed: int, N: int = 400, d: int = 8):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, N)
    X = np.column_stack([y * 1.5 + rng.normal(0, 0.8, N) for _ in range(d)])
    return X, y


def serve(scheduler: Scheduler, datasets, p):
    ids = [scheduler.submit(X, y, plan=p) for X, y in datasets]
    scheduler.run()
    results = []
    for jid in ids:
        job = scheduler.jobs[jid]
        _check(job.phase == "done", f"job {jid} failed: {job.error!r}")
        results.append(job.result)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    automl = AutoMLConfig(n_trials=10, rungs=(8, 16))
    cold_plan = plan("mc", budget=200, fine_tune=False, sub_automl=automl, warm_start=False)
    warm_plan = plan("mc", budget=200, fine_tune=False, sub_automl=automl)
    history = [make_data(300 + i) for i in range(4)]
    evals = [make_data(400 + i) for i in range(4)]

    # -- history phase, then a server restart from the snapshot ------------
    hist = Scheduler(warm_min_history=len(history) + 1, device=dev)
    serve(hist, history, warm_plan)
    blob = hist.snapshot()
    restored = Scheduler(device=dev)
    restored.load_snapshot(blob)

    live_bytes = wire.dumps(hist.experience.state_dict())
    rest_bytes = wire.dumps(restored.experience.state_dict())
    _check(live_bytes == rest_bytes, "experience store changed across snapshot/restore")
    qX, qy = evals[0]
    feats = meta_features(factorize(qX, qy, device=dev))
    for store in (hist.experience, restored.experience):
        _check(store.n_trained() == len(history), store.n_trained())
    p_live = portfolio_for(hist.experience, feats, k=6, knn=4)
    p_rest = portfolio_for(restored.experience, feats, k=6, knn=4)
    _check(p_live == p_rest, "portfolio decision changed across restore")
    print(f"snapshot round-trip OK: {len(history)} trained fingerprints, "
          f"portfolio of {len(p_live)} specs identical")

    # -- cold baseline on fresh datasets -----------------------------------
    cold = serve(Scheduler(device=dev), evals, cold_plan)
    cold_accs = [float(r.intermediate.val_acc) for r in cold]
    cold_trials = [r.intermediate.n_trials for r in cold]

    # -- warm serving on the restarted scheduler ---------------------------
    warm_server = SubStratServer(scheduler=restored)
    ids = [warm_server.submit(X, y, plan=warm_plan) for X, y in evals]
    warm = [warm_server.result(jid) for jid in ids]
    warm_trials = [r.intermediate.n_trials for r in warm]
    for i, (r, target) in enumerate(zip(warm, cold_accs)):
        acc = float(r.intermediate.val_acc)
        _check(acc >= target - 1e-6, f"warm job {i}: {acc} < cold winner {target}")
    _check(sum(warm_trials) < sum(cold_trials),
           f"warm dispatched {sum(warm_trials)} trials, cold {sum(cold_trials)}: no savings")
    print(f"warm run OK: reached all {len(evals)} cold winner accuracies "
          f"in {sum(warm_trials)} trials vs cold {sum(cold_trials)}")

    # -- the metrics surface saw it ----------------------------------------
    text = warm_server.metrics_text()

    def metric_value(name: str) -> float:
        total = 0.0
        for line in text.splitlines():
            if line.startswith(name) and " " in line:
                total += float(line.rsplit(" ", 1)[1])
        return total

    hits = metric_value("portfolio_hits_total")
    saved = metric_value("portfolio_trials_saved_total")
    _check(hits == len(evals), f"portfolio_hits_total {hits} != {len(evals)}")
    _check(saved > 0, "portfolio_trials_saved_total is zero")
    print(f"metrics OK: portfolio_hits_total={hits:.0f}, "
          f"portfolio_trials_saved_total={saved:.0f}")
    print("warm-start gate PASS")
    return 0


if __name__ == "__main__":
    main()
