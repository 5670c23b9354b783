"""End-to-end LM training with SubStrat corpus selection (after the JAX
package's ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_lm                  # smoke config
    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset full    # ~130M mamba2

Trains the mamba2-130m architecture (its smoke config by default) for a few
hundred steps, twice: once on the full synthetic corpus and once on a
Gen-DST entropy-preserving subset of it (SubStrat step 1 at LM scale), with
checkpoints under ``checkpoints/full`` and ``checkpoints/substrat`` of the
working directory.  A run finds its last checkpoint there and resumes.
A wrapper over ``launch/train.py``.
"""
from __future__ import annotations

import argparse

from .train import main as train_main

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=["cpu-small", "full"], default="cpu-small")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    common = ["--arch", args.arch, "--preset", args.preset, "--steps", str(args.steps),
              "--batch", "8", "--seq", "128", "--device", args.device]

    print("=== run A: full corpus ===")
    full = train_main(common + ["--ckpt-dir", "checkpoints/full"])

    print("\n=== run B: SubStrat-selected corpus subset (step 1 of the paper "
          "strategy at LM scale) ===")
    sub = train_main(common + ["--substrat-subset", "256",
                               "--ckpt-dir", "checkpoints/substrat"])
    return full, sub


if __name__ == "__main__":
    main()
