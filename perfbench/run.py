"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload substrat.d1 --seed 7 --seconds 45 --trace 0

Run from the root of a checkout: ``BENCHMARK.json`` names the cells, and the
system under test, ``repro_torch``, is imported from ``src/``.  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checked``: each number compared, as [worst reading, limit]).  The same
numbers close standard error.  The run exits non-zero and prints no result
without the CUDA cards the cell asks for, or when a module of JAX or of the
JAX package was loaded.
"""
import time

T_PROCESS = time.time()

import argparse   # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path   # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()


def _caches(root: Path) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = root / "build" / "perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches(ROOT)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    from pbcore.modules import forbidden_loaded
    from pbcore.spec import Cell

    cell = Cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here, before any result, without src/)
    from pbcore.cell import run_cell
    from pbcore.output import result_line

    def log(msg):
        print(f"perfbench: {msg}", file=sys.stderr, flush=True)

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS, log)
    found = forbidden_loaded(list(sys.modules))
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 3
    line, err = result_line(out, torch.cuda.get_device_name(0), cell.chips)
    for msg in err:
        log(msg)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
