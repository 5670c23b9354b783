"""Baseline comparison (the paper's Table 4, one dataset): SubStrat
against the baseline subset strategies against Full-AutoML (after the JAX
package's ``examples/automl_tabular.py``).

    PYTHONPATH=src python -m repro_torch.launch.automl_tabular --dataset D6 --scale 0.2 \
        [--methods SubStrat MC-100 ...] [--backend batched|loop] [--device cuda]

``--backend`` switches every AutoML pass (full, sub, fine-tune) between the
batched cohort engine and the sequential one.  The protocol is
``launch/compare.run_dataset``'s.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..data.tabular import PAPER_DATASETS
from .compare import QUICK_AUTOML, run_dataset, substrat_config

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="D6", choices=sorted(PAPER_DATASETS))
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--methods", nargs="*", default=None)
    ap.add_argument("--backend", default="batched", choices=("batched", "loop"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    full, results = run_dataset(
        PAPER_DATASETS[args.dataset], scale=args.scale, methods=args.methods,
        full_cfg=dataclasses.replace(QUICK_AUTOML, backend=args.backend),
        sub_cfg=substrat_config(automl_backend=args.backend), device=args.device,
    )
    print(f"\n{args.dataset}: Full-AutoML {full.time_s:.1f}s, "
          f"test-acc {full.test_acc:.3f}\n")
    print(f"{'method':14s} {'time':>8s} {'time-red':>9s} {'acc':>6s} {'rel-acc':>8s}")
    for r in sorted(results, key=lambda r: -r.relative_accuracy):
        print(f"{r.method:14s} {r.time_s:7.1f}s {r.time_reduction:+8.1%} "
              f"{r.test_acc:6.3f} {r.relative_accuracy:7.1%}")
    return full, results


if __name__ == "__main__":
    main()
