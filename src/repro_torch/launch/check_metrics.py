"""Metrics smoke gate: scrape ``GET /v1/metrics`` during a real serve run and
validate the exposition (after the JAX package's ``examples/check_metrics.py``).

    PYTHONPATH=src python -m repro_torch.launch.check_metrics [--jobs 2] [--scale 0.1]
        [--trials 4] [--device cuda]

Stands up the HTTP front end on localhost over an in-process scheduler on
``--device``, submits ``--jobs`` jobs (job ``i`` with ``seed=i``; every job
after the first repeats the first's dataset, so the DST cache hits), waits
for them over ``/v1/result``, then scrapes ``/v1/metrics`` and fails (exit
1) unless

- every non-comment line parses as a Prometheus 0.0.4 sample,
- every sample's family carries ``# TYPE``/``# HELP`` headers,
- the dispatch counters are nonzero (``dispatches_total`` summed over its
  ``mode`` children >= 1, and ``dispatch_latency_seconds_count`` agrees),
- the DST cache saw the repeat (``cache_hits_total >= 1``),
- ``jobs_finished_total`` equals the jobs, and
- the kernel accounting is live.

The last check is where the port differs from the reference, which
requires ``jax_jit_tracings_total > 0``: a cold JAX process must trace to
finish a job.  The port traces nothing.  Its build counter,
``torch_kernel_builds_total``, counts ``nvcc`` builds only, and a process
that loads an already-built library reports one ``site="none"`` sample at
0, so "nonzero builds" would pass only on a cold build directory.  What is
live is ``kernel_launches_total{kernel=...}``: the gate zeroes the launch
counters before it serves, and on a card requires both families typed and
``kernel_launches_total`` > 0 for ``masked_histogram`` and
``fused_delta_fitness`` (Gen-DST's two kernels).  On the CPU the kernels'
plain versions run and launch nothing, so there it requires the two
families to be typed.
"""
from __future__ import annotations

import argparse
import re

from .. import kernels
from ..automl.engine import AutoMLConfig
from ..core.gen_dst import GenDSTConfig
from ..core.plan import plan
from ..data.tabular import PAPER_DATASETS, make_dataset, train_test_split
from ..device import resolve_device
from ..service import SubStratHTTPClient, SubStratHTTPServer, SubStratServer

__all__ = ["main", "parse_exposition", "labelled_values"]

# sample line: name{label="v",...} value; the value may be int/float/+Inf
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|\+Inf|-Inf|NaN))$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str):
    """Validate the text format; returns {sample name: summed value} and the
    set of families that carried TYPE headers.  Raises ValueError with the
    offending line on any malformed input."""
    typed, helped, sums = set(), set(), {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            typed.add(parts[2])
            continue
        if line.startswith("# HELP "):
            if len(line.split(" ", 3)) < 3:
                raise ValueError(f"line {lineno}: malformed HELP: {line!r}")
            helped.add(line.split(" ", 3)[2])
            continue
        if line.startswith("#"):
            continue   # free-form comment: legal
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name, value = m.group(1), m.group(3)
        # a histogram's series sample under the family's TYPE header
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and family not in typed:
            raise ValueError(f"line {lineno}: sample {name!r} precedes its TYPE header")
        if value not in ("+Inf", "-Inf", "NaN"):
            sums[name] = sums.get(name, 0.0) + float(value)
    return sums, typed


def labelled_values(text: str, name: str, label: str) -> dict:
    """``{label value: sample value}`` of the samples of ``name`` (parsed
    with ``parse_exposition``'s grammar)."""
    out = {}
    for line in text.splitlines():
        m = _SAMPLE_RE.match(line)
        if m and m.group(1) == name and m.group(2):
            labels = dict(_LABEL_RE.findall(m.group(2)))
            if label in labels:
                out[labels[label]] = float(m.group(3))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    X, y = make_dataset(PAPER_DATASETS["D3"], scale=args.scale)
    Xtr, ytr, Xte, yte = train_test_split(X, y)
    p = plan("gen_dst", cfg=GenDSTConfig(psi=8, phi=20),
             sub_automl=AutoMLConfig(n_trials=args.trials, rungs=(30, 80)),
             ft_automl=AutoMLConfig(n_trials=4, rungs=(80,)))

    kernels.reset_launch_counts()
    http = SubStratHTTPServer(SubStratServer(device=dev)).start()
    failures = []
    try:
        client = SubStratHTTPClient(http.url)
        ids = [client.submit(Xtr, ytr, tenant="acme", seed=i, plan=p, X_test=Xte, y_test=yte)
               for i in range(args.jobs)]
        for jid in ids:
            client.result(jid)

        text = client.metrics()
        print(f"scraped {len(text.splitlines())} exposition lines "
              f"from {http.url}/v1/metrics")
        try:
            sums, typed = parse_exposition(text)
        except ValueError as e:
            print(f"FAIL: {e}")
            return 1

        def check(cond, what):
            print(("ok:   " if cond else "FAIL: ") + what)
            if not cond:
                failures.append(what)

        dispatches = sum(v for n, v in sums.items() if n == "dispatches_total")
        check(dispatches >= 1, f"dispatches_total summed over modes >= 1 (got {dispatches})")
        check(sums.get("dispatch_latency_seconds_count", 0.0) == dispatches,
              "dispatch_latency_seconds_count agrees with dispatches_total")
        check(sums.get("cache_hits_total", 0.0) >= 1,
              "cache_hits_total >= 1 (job 1 repeats job 0's dataset)")
        check(sums.get("jobs_finished_total", 0.0) == len(ids),
              f"jobs_finished_total == {len(ids)}")
        check("torch_kernel_builds_total" in typed and "kernel_launches_total" in typed,
              "torch_kernel_builds_total and kernel_launches_total present")
        if dev.type == "cuda":
            launches = labelled_values(text, "kernel_launches_total", "kernel")
            for name in kernels.GEN_DST_KERNELS:
                check(launches.get(name, 0.0) > 0,
                      f'kernel_launches_total{{kernel="{name}"}} > 0 '
                      f"(got {launches.get(name)})")
    finally:
        http.close()
        if hasattr(http.server.scheduler, "close"):
            http.server.scheduler.close()

    print(f"metrics smoke: {len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
