"""The readings a cell's limits are set from (not run by the benchmark).

    python3 perfbench/readings.py --workload substrat.d1 --seeds 11,12,13 --seconds 45 [--control]

For each seed, the jobs a run of ``--seconds`` checks go through the program
at the cell's sizes, and their answers through the comparison: the sound
readings.  With ``--control`` the reference, in the precision below the
configuration's, takes the program's place for the same jobs: the control's
readings.  Prints one JSON line per job, then the largest sound reading
and the smallest control reading of each number, a seed's reading being
what a run of it reads (the worst job's, or the sum over its jobs for the
summed counts).
"""
import argparse
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--jobs", type=int, default=None, help="jobs per seed (default: a run's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    from pbcore.cell import readings
    from pbcore.compare import verdict
    from pbcore.spec import Cell

    cell = Cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(cell, seeds, args.seconds, args.device, args.control, args.jobs,
                    log=lambda r: print(json.dumps(r, default=str), flush=True))
    summary = {}
    for side, pick in (("program", max), ("control", min)):
        per_seed = [verdict([r[side] for r in rows if r["seed"] == s and side in r], {})[1]
                    for s in seeds]
        per_seed = [p for p in per_seed if p]
        summary[side] = {k: pick(p[k] for p in per_seed) for k in sorted(set().union(*per_seed))}
    print(json.dumps({"workload": args.workload, "seeds": seeds, "jobs": len(rows),
                      **{k: {n: (v if math.isfinite(v) else str(v)) for n, v in s.items()}
                         for k, s in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
