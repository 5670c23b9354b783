"""The port's span API (``repro_torch/obs/trace.py``): the collecting sink,
ids unique within a trace, parents, and the timeline of one job's tree."""
from repro_torch.obs import trace


def test_span_outside_collect_records_nothing():
    with trace.span(None, None, "factorize.host", rows=3) as sp:
        assert trace.current_span() is None
    assert sp["t1"] >= sp["t0"] > 0 and sp["attrs"] == {"rows": 3}
    assert "span_id" not in sp
    # an explicit sink still records, with the serving tier's pure id
    sink = []
    with trace.span(sink, "t", "eval", attempt=2, parent_id="p", worker=1):
        pass
    assert sink[0]["span_id"] == trace.span_id("t", "eval", 2)
    assert sink[0]["parent_id"] == "p" and sink[0]["attrs"] == {"worker": 1}


def test_nested_spans_get_unique_ids_and_their_parents():
    sink = []
    with trace.collect(sink):
        with trace.span(None, None, "gen_dst") as root:
            for g in range(3):
                with trace.span(None, None, "gen_dst.generation", gen=g):
                    with trace.span(None, None, "inner"):
                        pass
        with trace.span(None, None, "gen_dst"):
            pass
    assert trace.current_span() is None
    names = [s["name"] for s in sink]
    # closed spans, innermost first
    assert names == ["inner", "gen_dst.generation"] * 3 + ["gen_dst", "gen_dst"]
    assert len({s["span_id"] for s in sink}) == len(sink)
    assert len({s["trace_id"] for s in sink}) == 1
    gens = [s for s in sink if s["name"] == "gen_dst.generation"]
    assert [g["attrs"]["gen"] for g in gens] == [0, 1, 2]
    assert all(g["parent_id"] == root["span_id"] for g in gens)
    inner = [s for s in sink if s["name"] == "inner"]
    assert [i["parent_id"] for i in inner] == [g["span_id"] for g in gens]
    roots = [s for s in sink if s["parent_id"] is None]
    assert len(roots) == 2 and roots[0]["t1"] <= roots[1]["t0"]
    # the same tree again is another trace: no id is shared with the first
    again = []
    with trace.collect(again):
        with trace.span(None, None, "gen_dst"):
            for g in range(3):
                with trace.span(None, None, "gen_dst.generation", gen=g):
                    with trace.span(None, None, "inner"):
                        pass
        with trace.span(None, None, "gen_dst"):
            pass
    assert [s["name"] for s in again] == names
    assert again[0]["trace_id"] != sink[0]["trace_id"]
    assert not {s["span_id"] for s in again} & {s["span_id"] for s in sink}


def test_each_collect_is_a_trace_and_a_nested_one_feeds_both_sinks():
    outer, inner, other = [], [], []
    with trace.collect(outer):
        with trace.span(None, None, "sub_automl"):
            with trace.collect(inner):
                with trace.span(None, None, "automl.rung", rung=0):
                    pass
    with trace.collect(other):
        with trace.span(None, None, "sub_automl"):
            pass
    assert [s["name"] for s in inner] == ["automl.rung"]
    assert [s["name"] for s in outer] == ["automl.rung", "sub_automl"]
    assert inner[0] is outer[0] and inner[0]["parent_id"] == outer[1]["span_id"]
    assert outer[0]["trace_id"] == outer[1]["trace_id"] != other[0]["trace_id"]


def test_a_span_that_raises_is_kept_and_flagged():
    sink = []
    try:
        with trace.collect(sink):
            with trace.span(None, None, "automl.rung.issue"):
                raise ValueError("boom")
    except ValueError:
        pass
    assert sink[0]["attrs"]["error"] is True and trace.current_span() is None


def test_render_timeline_draws_one_jobs_tree():
    sink = []
    with trace.collect(sink):
        for phase in ("factorize", "gen_dst"):
            with trace.span(None, None, phase, phase=phase):
                if phase == "factorize":
                    with trace.span(None, None, "factorize.host"):
                        pass
                else:
                    for g in range(2):
                        with trace.span(None, None, "gen_dst.generation", gen=g):
                            pass
    lines = trace.render_timeline(sink).splitlines()
    labels = [ln.split("|")[0].rstrip() for ln in lines]
    assert labels == ["factorize", "  factorize.host", "gen_dst",
                      "  gen_dst.generation", "  gen_dst.generation"]
    assert "phase=gen_dst" in lines[2] and "gen=1" in lines[4]
