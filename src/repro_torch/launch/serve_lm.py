"""Batched serving example: prefill + token-by-token decode with a KV cache
(or SSM state), on any assigned architecture's reduced config (after the
JAX package's ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-8b [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch mamba2-130m --gen 32

A wrapper over ``launch/serve.py`` at the smoke preset, sampling at
temperature 0.8.
"""
from __future__ import annotations

import argparse

from .serve import main as serve_main

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_main(["--arch", args.arch, "--gen", str(args.gen),
                       "--temperature", "0.8", "--device", args.device])


if __name__ == "__main__":
    main()
