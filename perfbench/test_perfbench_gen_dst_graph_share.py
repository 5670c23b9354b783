"""CPU tests of ``metrics/gen_dst_graph_share.py`` on hand-made records: per
job, the ``gen_graphed`` of the ``gen_dst.generation`` spans summed over
their number, averaged over the window's jobs that ran a generation; a round
of ``manymodels.d1`` (eight searches) is one job; None where the program's
generation spans carry no ``gen_graphed``."""
import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE)]

from pbcore.spec import load_module    # noqa: E402

read = load_module(HERE / "metrics" / "gen_dst_graph_share.py").read


def sp(name, t0, t1, sid, **attrs):
    return {"trace_id": "t", "span_id": sid, "parent_id": None, "name": name,
            "attempt": 0, "t0": t0, "t1": t1, "attrs": attrs}


def search_spans(k, graphed):
    """One search: ``gen_dst.init``, one ``gen_dst.generation`` span per entry
    of ``graphed`` (its ``gen_graphed``; None leaves the attribute out, as a
    program older than it does), ``gen_dst.to_host``."""
    spans = [sp("gen_dst.init", 0.0, 0.01, f"{k}i")]
    for g, flag in enumerate(graphed):
        attrs = {"gen": g} if flag is None else {"gen": g, "gen_graphed": flag}
        spans.append(sp("gen_dst.generation", 0.01 + g, 0.02 + g, f"{k}g{g}", **attrs))
    return spans + [sp("gen_dst.to_host", 40.0, 40.1, f"{k}h")]


def record(*searches):
    """A job's record: its phase spans and the spans of its searches."""
    spans = [sp("factorize", 0.0, 0.1, "f", phase="factorize"),
             sp("gen_dst", 0.1, 41.0, "d", phase="gen_dst")]
    for k, graphed in enumerate(searches):
        spans += search_spans(f"s{k}", graphed)
    return {"result": types.SimpleNamespace(spans=[]), "spans": spans}


def run_of(records):
    return types.SimpleNamespace(jobs=[{"record": r} for r in records], stretch=None)


PAPER = [0] + [1] * 29             # the paper's defaults: generation 0 eager, 29 replayed


@pytest.mark.parametrize("records,want", [
    ([record(PAPER)], 29 / 30),
    ([record(PAPER), record([0] * 30), record([0, 0] + [1] * 28)],
     (29 / 30 + 0.0 + 28 / 30) / 3),
    # a job with no search (an AutoML-only job) is left out of the mean
    ([record(PAPER), record()], 29 / 30),
    # a round of manymodels.d1: eight solo searches in one job
    ([record(*[PAPER] * 7, [0] * 30), record(*[PAPER] * 8)],
     ((7 * 29) / 240 + (8 * 29) / 240) / 2),
], ids=["one_job", "mean_over_jobs", "job_without_a_search", "many_models_rounds"])
def test_gen_dst_graph_share_per_job(records, want):
    assert read(run_of(records)) == pytest.approx(want)


@pytest.mark.parametrize("records", [
    [record([None] * 30), record([None] * 30)],
    [record(*[[None] * 30] * 8)],
    [record()],
    [{"result": object(), "spans": [{"name": "automl_fit", "t0": 0.0, "t1": 1.0}]}],
], ids=["solo_without_the_attr", "round_without_the_attr", "no_search", "automl_job"])
def test_gen_dst_graph_share_reads_none(records):
    """A program whose generation spans carry no ``gen_graphed`` (the parent
    of the graphed generations), or a window with no generation, reads None,
    and the reader does not raise."""
    assert read(run_of(records)) is None
