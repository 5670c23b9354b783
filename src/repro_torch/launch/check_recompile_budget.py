"""Recompile-budget gate: steady-state serving must build no kernel (after the
JAX package's ``examples/check_recompile_budget.py``).

    PYTHONPATH=src python -m repro_torch.launch.check_recompile_budget
        [--rounds 2] [--jobs 2] [--scale 0.1] [--trials 4] [--device cuda]

Round 0 is the warmup: it pays whatever the process builds (on a card, the
CUDA kernels' one build unless a build already loaded them).  The gate
then snapshots ``obs.torchprof.tracing_snapshot()`` and replays
``--rounds`` more rounds of same-shaped traffic: same datasets, same plan,
fresh seeds.  The steady state must add zero builds; any nonzero delta
prints the offending sources and exits 1.  The reference counts jit
tracings here; the port traces nothing, and ``kernels/_build.library()``
keeps the library it loaded, so 0 new builds is what the port is built to
give.  The gate stays: a build inside the serving path would be a fault.
Each round, and the Gen-DST leg below, also prints its launches of the
Gen-DST kernels (B1 ``masked_histogram``, B2 ``fused_delta_fitness``),
which the gate does not judge: the steady-state rounds repeat round 0's
datasets, so their searches are DST-cache hits and launch neither.

Plans run with ``fine_tune=False``, as in the reference.  The second half
runs Gen-DST directly: one warmup ``gen_dst`` call, then ``--rounds``
same-shaped calls with fresh seeds must add zero builds.  The reference
loops over its ``GEN_DST_BACKENDS``; the port has no backend switch (the
device picks the kernels or their plain versions), so this is one leg on
``--device``.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import kernels
from ..automl.engine import AutoMLConfig
from ..core.gen_dst import GenDSTConfig, gen_dst
from ..core.measures import factorize
from ..core.plan import plan
from ..data.tabular import PAPER_DATASETS, make_dataset, train_test_split
from ..device import make_generator, resolve_device
from ..obs import torchprof
from ..service import SubStratServer

__all__ = ["main"]


def _gen_dst_launches(before: dict) -> str:
    """B1's and B2's launches since the counts ``before``."""
    counts = kernels.launch_counts()
    return ", ".join(f"{k} {counts[k] - before[k]}" for k in kernels.GEN_DST_KERNELS)


def run_round(srv, datasets, p, n_jobs, seed0):
    ids = []
    for i in range(n_jobs):
        name, Xtr, ytr, Xte, yte = datasets[i % len(datasets)]
        ids.append(srv.submit(Xtr, ytr, tenant="acme", seed=seed0 + i, plan=p,
                              X_test=Xte, y_test=yte))
    srv.run()
    for jid in ids:
        st = srv.poll(jid)
        if st.phase != "done":
            raise RuntimeError(f"job {jid} ended in {st.phase}")
    return ids


def check_gen_dst(rounds: int, device) -> int:
    """Warmup + ``rounds`` same-shaped ``gen_dst`` calls on ``device``: the
    steady state must add 0 builds.  Returns 1 on failure, else 0."""
    rng = np.random.default_rng(0)
    X = np.column_stack([rng.integers(0, k, 2_000) for k in (3, 5, 17, 2, 40)]).astype(float)
    y = rng.integers(0, 2, 2_000).astype(float)
    coded = factorize(X, y, device=device)
    cfg = GenDSTConfig(psi=4, phi=8, cross_every=2)
    before = kernels.launch_counts()
    float(gen_dst(make_generator(0, device), coded, 20, 3, cfg, device=device).fitness)
    warm = torchprof.tracing_snapshot()
    for r in range(rounds):
        float(gen_dst(make_generator(1 + r, device), coded, 20, 3, cfg,
                      device=device).fitness)
    delta = torchprof.new_tracings_since(warm)
    if delta:
        print(f"FAIL: gen_dst on {device} built kernels after warmup:")
        for site, n in sorted(delta.items()):
            print(f"  {site}: +{int(n)}")
        return 1
    print(f"gen_dst on {device}: 0 new builds ({rounds} same-shaped rounds, fresh seeds); "
          f"launches over the warmup and the rounds {_gen_dst_launches(before)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="steady-state rounds replayed after the warmup")
    ap.add_argument("--jobs", type=int, default=2,
                    help="jobs per round (constant so megabatch group "
                         "sizes match between warmup and steady state)")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    datasets = []
    for name in ("D3", "D6")[:max(1, min(2, args.jobs))]:
        X, y = make_dataset(PAPER_DATASETS[name], scale=args.scale)
        Xtr, ytr, Xte, yte = train_test_split(X, y)
        datasets.append((name, Xtr, ytr, Xte, yte))

    p = plan("gen_dst", cfg=GenDSTConfig(psi=8, phi=20), fine_tune=False,
             sub_automl=AutoMLConfig(n_trials=args.trials, rungs=(30, 80)))

    srv = SubStratServer(device=dev)
    before = kernels.launch_counts()
    run_round(srv, datasets, p, args.jobs, seed0=0)
    warm = torchprof.tracing_snapshot()
    print(f"warmup: {int(sum(warm.values()))} kernel builds across "
          f"{len(warm)} sources; launches {_gen_dst_launches(before)}")
    for site, n in sorted(warm.items()):
        print(f"  {site}: {int(n)}")

    for r in range(args.rounds):
        before = kernels.launch_counts()
        run_round(srv, datasets, p, args.jobs, seed0=100 * (r + 1))
        delta = torchprof.new_tracings_since(warm)
        if delta:
            print(f"FAIL: round {r + 1} built kernels after warmup:")
            for site, n in sorted(delta.items()):
                print(f"  {site}: +{int(n)}")
            return 1
        print(f"round {r + 1}: 0 new builds ({args.jobs} jobs, fresh seeds, same shapes); "
              f"launches {_gen_dst_launches(before)}")

    if check_gen_dst(args.rounds, dev):
        return 1

    print("recompile budget: PASS (steady state adds 0 kernel builds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
