"""CPU tests of the readers of the program's own spans (``pbcore/spans.py``
and the metrics that read it) on hand-made records and a hand-made trace:
each reads what it should, counts a span once, and reads None where a
program records no such span."""
import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from pbcore.profiling import Stretch   # noqa: E402
from pbcore.spec import load_module    # noqa: E402

READERS = ("factorize_host_s", "factorize_copy_s", "gen_dst_gen_s", "gen_dst_to_host_s",
           "gen_dst_ops_per_gen", "automl_prep_s", "automl_issue_s", "automl_wait_s",
           "adam_steps_per_job", "adam_trials_per_step")


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py").read


def sp(name, t0, t1, sid, **attrs):
    return {"trace_id": "t", "span_id": sid, "parent_id": None, "name": name,
            "attempt": 0, "t0": t0, "t1": t1, "attrs": attrs}


def automl_spans(k, steps, trials, prep=0.05, issue=0.2, wait=0.01):
    """One AutoML pass: init, one rung's prep/issue/wait, result."""
    return [sp("automl.init", 0.0, 0.01, f"{k}i"),
            sp("automl.rung.prep", 0.01, 0.01 + prep, f"{k}p"),
            sp("automl.rung.issue", 1.0, 1.0 + issue, f"{k}s", adam_steps=steps,
               trial_steps=trials),
            sp("automl.rung.wait", 2.0, 2.0 + wait, f"{k}w"),
            sp("automl.rung", 0.0, 3.0, f"{k}r", rung=0),
            sp("automl.result", 3.0, 3.1, f"{k}x")]


def substrat_record(j, host, copy, gens, steps):
    spans = [sp("factorize.host", 0.0, host, f"{j}fh"),
             sp("factorize.copy", host, host + copy, f"{j}fc"),
             sp("factorize", 0.0, host + copy, f"{j}f", phase="factorize")]
    spans += [sp("gen_dst.generation", 1.0 + g, 1.0 + g + d, f"{j}g{g}", gen=g)
              for g, d in enumerate(gens)]
    spans += [sp("gen_dst.to_host", 9.0, 9.004, f"{j}th")]
    sub, ft = automl_spans(f"{j}a", steps, 2 * steps), automl_spans(f"{j}b", 10, 10)
    spans += sub + ft
    # a result that also holds some of the same records: counted once
    return {"result": types.SimpleNamespace(spans=ft), "spans": spans}


def automl_record(steps, trials):
    """An ``automl.*`` record: the adapter's one span, the result's spans."""
    return {"result": types.SimpleNamespace(spans=automl_spans("a", steps, trials)),
            "spans": [{"name": "automl_fit", "t0": 0.0, "t1": 4.0}]}


def run_of(records, stretch=None):
    return types.SimpleNamespace(jobs=[{"record": r} for r in records], stretch=stretch)


SUBSTRAT = run_of([substrat_record(0, 0.4, 0.004, [0.003, 0.005], 100),
                   substrat_record(1, 0.5, 0.006, [0.004], 300)])
AUTOML = run_of([automl_record(120, 260), automl_record(100, 240)])


@pytest.mark.parametrize("name,want", [
    ("factorize_host_s", 0.45), ("factorize_copy_s", 0.005), ("gen_dst_gen_s", 0.004),
    ("gen_dst_to_host_s", 0.004), ("automl_prep_s", 0.12), ("automl_issue_s", 0.4),
    ("automl_wait_s", 0.02), ("adam_steps_per_job", 210.0),
    ("adam_trials_per_step", (200 + 600 + 20) / 420),
])
def test_readers_on_substrat_records(name, want):
    assert reader(name)(SUBSTRAT) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [
    ("automl_prep_s", 0.06), ("automl_issue_s", 0.2), ("automl_wait_s", 0.01),
    ("adam_steps_per_job", 110.0), ("adam_trials_per_step", 500 / 220),
    ("factorize_host_s", None), ("gen_dst_gen_s", None), ("gen_dst_ops_per_gen", None),
])
def test_readers_on_automl_records(name, want):
    got = reader(name)(AUTOML)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_a_program_without_the_spans(name):
    """A program that records only the phase spans (and an AutoML result
    without ``spans``) reads None, and no reader raises."""
    phases = [{"name": n, "t0": 0.0, "t1": 1.0, "span_id": n, "trace_id": "t",
               "parent_id": None, "attrs": {"phase": n}}
              for n in ("factorize", "gen_dst", "sub_automl", "fine_tune")]
    old = [{"result": types.SimpleNamespace(final=None), "spans": phases},
           {"result": object(), "spans": [{"name": "automl_fit", "t0": 0.0, "t1": 1.0}]}]
    stretch = Stretch([("k", 10, 20)], (0, 100), [(s["name"], 0, 50) for s in phases], 1)
    assert reader(name)(run_of(old, stretch)) is None


def test_ops_per_generation_from_the_trace():
    # two generations; a third span of another kind; operations before,
    # inside and between them
    spans = [("gen_dst", 0, 1000), ("gen_dst.generation", 100, 200),
             ("gen_dst.generation", 300, 400), ("automl.rung", 500, 900)]
    ops = [("a", 50, 60), ("b", 100, 150), ("c", 150, 250), ("d", 250, 260),
           ("e", 300, 310), ("f", 399, 420), ("g", 410, 420), ("h", 600, 700)]
    run = run_of([], Stretch(ops, (0, 1000), spans, 1))
    assert reader("gen_dst_ops_per_gen")(run) == 2.0    # (b, c) and (e, f)
    assert reader("gen_dst_ops_per_gen")(run_of([], None)) is None


def test_adam_trials_per_step_needs_a_step():
    run = run_of([automl_record(0, 0)])
    assert reader("adam_steps_per_job")(run) == 0.0
    assert reader("adam_trials_per_step")(run) is None
