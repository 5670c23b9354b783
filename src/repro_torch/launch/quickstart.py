"""Quickstart: SubStrat against Full-AutoML on a paper-shaped tabular dataset
(after the JAX package's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--scale 0.5] [--trials 10]
        [--backend batched|loop] [--strategy gen_dst|mc|...] [--device cuda]

The paper's headline comparison on one dataset (D3): the AutoML engine on
the full data, then a SubStrat ``Plan`` (subset strategy -> AutoML ->
restricted fine-tune), reported as time-reduction and relative accuracy.
``--scale 0.1 --trials 4`` is the CI smoke configuration; ``--backend
loop`` pins the sequential AutoML engine; ``--strategy`` swaps the subset
finder across the SubsetStrategy registry (Gen-DST by default).  The plan
runs with ``seed=0`` where the reference passes ``key=jax.random.key(0)``.
Neither pass is warmed up: on a card, Full-AutoML's pass also pays the
process's first cuBLAS and allocator costs and SubStrat's the first kernel
build, as the reference's passes pay their jit compiles.
"""
from __future__ import annotations

import argparse
import time

from ..automl.engine import AutoMLConfig, automl_fit
from ..core.gen_dst import GenDSTConfig
from ..core.plan import execute, plan
from ..core.strategies import available_strategies
from ..data.tabular import PAPER_DATASETS, make_dataset, train_test_split
from ..device import resolve_device

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=0.5,
                    help="dataset row-count scale (0.1 = smoke size)")
    ap.add_argument("--trials", type=int, default=10,
                    help="AutoML trial budget for the full and sub passes")
    ap.add_argument("--backend", default="batched", choices=("batched", "loop"),
                    help="AutoML engine backend")
    ap.add_argument("--strategy", default="gen_dst", choices=available_strategies(),
                    help="SubsetStrategy registry entry")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = PAPER_DATASETS["D3"]           # car insurance, 10k x 18
    X, y = make_dataset(spec, scale=args.scale)
    Xtr, ytr, Xte, yte = train_test_split(X, y)
    print(f"dataset {spec.name} ({spec.domain}): {Xtr.shape[0]} train rows, "
          f"{Xtr.shape[1]} columns, engine backend {args.backend}, "
          f"subset strategy {args.strategy}, device {dev}")

    automl_cfg = AutoMLConfig(n_trials=args.trials, rungs=(60, 200), backend=args.backend)
    t0 = time.perf_counter()
    full = automl_fit(Xtr, ytr, config=automl_cfg, X_test=Xte, y_test=yte, device=dev)
    t_full = time.perf_counter() - t0
    print(f"\nFull-AutoML : {t_full:6.1f}s  test-acc {full.test_acc:.3f} "
          f"({full.spec.family}, {full.n_trials} trials)")

    opts = {"cfg": GenDSTConfig(psi=10, phi=24)} \
        if args.strategy in ("gen_dst", "gen_dst_islands") else {}
    p = plan(
        args.strategy,
        sub_automl=automl_cfg,
        ft_automl=AutoMLConfig(n_trials=4, rungs=(120,), backend=args.backend),
        **opts,
    )
    res = execute(p, Xtr, ytr, seed=0, X_test=Xte, y_test=yte, device=dev)
    print(f"SubStrat    : {res.total_time_s:6.1f}s  test-acc "
          f"{res.final.test_acc:.3f} ({res.final.spec.family})")
    print(f"  subset: {len(res.row_idx)} rows x {len(res.col_idx)}(+target) cols, "
          f"|H(d)-H(D)| = {-res.dst_fitness:.4f}")
    print(f"  phases: {', '.join(f'{k}={v:.1f}s' for k, v in res.times.items())}")
    time_reduction = 1 - res.total_time_s / t_full
    relative_accuracy = res.final.test_acc / full.test_acc
    print(f"\ntime-reduction     = {time_reduction:+.1%}")
    print(f"relative-accuracy  = {relative_accuracy:.1%}")
    return {"t_full": t_full, "full": full, "substrat": res,
            "time_reduction": time_reduction, "relative_accuracy": relative_accuracy}


if __name__ == "__main__":
    main()
