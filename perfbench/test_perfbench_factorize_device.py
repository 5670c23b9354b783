"""CPU tests of ``metrics/factorize_device_s.py``: on hand-made records the
seconds of the ``factorize.device`` spans per job, averaged over the
window's jobs; None where a program records no such span (one with the
per-column NumPy loop, or an ``automl.*`` job); and on a recorded ``execute``
on the CPU a positive number inside the job's ``factorize`` phase."""
import sys
import types
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from pbcore.spec import load_module    # noqa: E402

read = load_module(HERE / "metrics" / "factorize_device_s.py").read


def sp(name, t0, t1, sid):
    return {"trace_id": "t", "span_id": sid, "parent_id": None, "name": name,
            "attempt": 0, "t0": t0, "t1": t1, "attrs": {}}


def record(j, names_seconds):
    spans, t = [], 0.0
    for k, (name, sec) in enumerate(names_seconds):
        spans.append(sp(name, t, t + sec, f"{j}.{k}"))
        t += sec
    return {"result": types.SimpleNamespace(spans=[]), "spans": spans}


def run_of(records):
    return types.SimpleNamespace(jobs=[{"record": r} for r in records], stretch=None)


@pytest.mark.parametrize("records,want", [
    # one factorize a job: the mean over the window's jobs
    ([record(0, [("factorize.host", 1e-5), ("factorize.copy", 0.001),
                 ("factorize.device", 0.004)]),
      record(1, [("factorize.copy", 0.002), ("factorize.device", 0.006)])], 0.005),
    # a round of partitions: their device spans add up within the job
    ([record(0, [("factorize.device", 0.002)] * 8)], 0.016),
    # the parent's spans (the NumPy loop), and an AutoML job: nothing to read
    ([record(0, [("factorize.host", 0.45), ("factorize.copy", 0.004)])], None),
    ([{"result": object(), "spans": [{"name": "automl_fit", "t0": 0.0, "t1": 1.0}]}], None),
], ids=["jobs", "round", "numpy_loop", "automl"])
def test_reads_the_device_spans(records, want):
    got = read(run_of(records))
    assert got == (None if want is None else pytest.approx(want))


def test_reads_a_recorded_execute():
    from repro_torch.automl.engine import AutoMLConfig
    from repro_torch.core.gen_dst import GenDSTConfig
    from repro_torch.core.plan import execute, plan
    rng = np.random.default_rng(0)
    X = np.column_stack([rng.normal(size=400), rng.integers(0, 90, 400),
                         rng.integers(0, 3, 400)]).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.int64)
    sink = []
    execute(plan("gen_dst", n=20, m=2, cfg=GenDSTConfig(psi=2, phi=4),
                 sub_automl=AutoMLConfig(n_trials=2, rungs=(2,)), fine_tune=False),
            X, y, seed=3, trace_sink=sink, device="cpu")
    got = read(run_of([{"result": types.SimpleNamespace(spans=[]), "spans": sink}]))
    (phase,) = [s for s in sink if s["name"] == "factorize"]
    assert 0.0 < got <= phase["t1"] - phase["t0"]
