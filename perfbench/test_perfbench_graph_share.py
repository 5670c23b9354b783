"""CPU tests of ``metrics/adam_graph_share.py`` on hand-made records: per
job, the ``graph_steps`` counted on the ``automl.rung.issue`` spans over the
job's ``adam_steps``, averaged over the window's jobs that took a step; 0.0
where the program counts but replays nothing (the CPU), None where the
program does not count graph steps at all."""
import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from pbcore.spec import load_module    # noqa: E402

read = load_module(HERE / "metrics" / "adam_graph_share.py").read


def sp(name, t0, t1, sid, **attrs):
    return {"trace_id": "t", "span_id": sid, "parent_id": None, "name": name,
            "attempt": 0, "t0": t0, "t1": t1, "attrs": attrs}


def automl_spans(k, rungs):
    """One AutoML pass with one ``automl.rung.issue`` span per rung; a rung
    is ``(adam_steps, graph_steps)``, and ``graph_steps`` None leaves the
    count out, as a program older than it does."""
    spans = [sp("automl.init", 0.0, 0.01, f"{k}i")]
    for r, (steps, graph) in enumerate(rungs):
        counts = dict(adam_steps=steps, trial_steps=2 * steps)
        if graph is not None:
            counts["graph_steps"] = graph
        spans += [sp("automl.rung.issue", 1.0 + r, 1.2 + r, f"{k}s{r}", **counts),
                  sp("automl.rung", 0.0 + r, 2.0 + r, f"{k}r{r}", rung=r)]
    return spans + [sp("automl.result", 9.0, 9.1, f"{k}x")]


def substrat_record(j, sub_rungs, ft_rungs):
    """A ``substrat.*`` record: the sub-AutoML's and the fine-tune's spans in
    ``execute``'s sink; the fine-tune's result holds its spans again, and
    they count once."""
    ft = automl_spans(f"{j}b", ft_rungs)
    spans = [sp("factorize", 0.0, 0.4, f"{j}f", phase="factorize")]
    spans += automl_spans(f"{j}a", sub_rungs) + ft
    return {"result": types.SimpleNamespace(spans=ft), "spans": spans}


def automl_record(rungs):
    """An ``automl.*`` record: the adapter's one span, the result's spans."""
    return {"result": types.SimpleNamespace(spans=automl_spans("a", rungs)),
            "spans": [{"name": "automl_fit", "t0": 0.0, "t1": 4.0}]}


def run_of(records):
    return types.SimpleNamespace(jobs=[{"record": r} for r in records], stretch=None)


@pytest.mark.parametrize("records,want", [
    # sub-AutoML 100 steps (96 replayed) + fine-tune 10 (9); 300 (296) + 10 (9)
    ([substrat_record(0, [(60, 58), (40, 38)], [(10, 9)]),
      substrat_record(1, [(300, 296)], [(10, 9)])],
     (105 / 110 + 305 / 310) / 2),
    ([automl_record([(120, 117)]), automl_record([(70, 68), (30, 29)])],
     (117 / 120 + 97 / 100) / 2),
    # a job that took no step is left out of the mean
    ([automl_record([(120, 117)]), automl_record([(0, 0)])], 117 / 120),
    ([automl_record([(120, 0)]), automl_record([(100, 0)])], 0.0),
], ids=["substrat_records", "automl_records", "job_without_a_step", "no_graph_steps"])
def test_adam_graph_share_per_job(records, want):
    assert read(run_of(records)) == pytest.approx(want)


@pytest.mark.parametrize("records", [
    [automl_record([(120, None)]), automl_record([(100, None)])],
    [substrat_record(0, [(100, None)], [(10, None)])],
    [automl_record([(0, 0)])],
    # only the phase spans, and an AutoML result without ``spans``
    [{"result": types.SimpleNamespace(final=None),
      "spans": [sp(n, 0.0, 1.0, n, phase=n)
                for n in ("factorize", "gen_dst", "sub_automl", "fine_tune")]},
     {"result": object(), "spans": [{"name": "automl_fit", "t0": 0.0, "t1": 1.0}]}],
], ids=["automl_without_the_count", "substrat_without_the_count", "no_step_taken",
        "no_automl_spans"])
def test_adam_graph_share_reads_none(records):
    """A program that does not count graph steps, or a window in which no job
    took a step, reads None, and the reader does not raise."""
    assert read(run_of(records)) is None
