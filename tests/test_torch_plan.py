"""The port's plan API end to end on the CPU, and against the reference.

With the same subset (the reference's Gen-DST result, handed to both
packages as a callable strategy), both packages' ``execute`` pick the same
intermediate and final model family, and their final test accuracies agree
within 2/N_test for each of 3 seeds and each AutoML backend (both packages
given the same ``backend=``).  The AutoML seed is one whose sampled
population has no MLP, since ``execute`` draws the MLP's init with torch.
"""
import types

import jax
import numpy as np
import pytest
import torch

import repro.core.gen_dst as JG
import repro_torch.automl.batched as t_batched
import repro_torch.automl.models as t_models
import repro_torch.core.gen_dst as TG
import repro_torch.service.wire as t_wire
import repro_torch.service.worker as t_worker
from repro.automl.engine import AutoMLConfig as JCfg
from repro.core.measures import factorize as j_factorize
from repro.core.plan import execute as j_execute, plan as j_plan
from repro_torch.automl.engine import AutoMLConfig as TCfg
from repro_torch.automl.engine import automl_fit as t_automl_fit
from repro_torch.automl.engine import search_init as t_search_init
from repro_torch.automl.engine import search_trial_cohort as t_search_trial_cohort
from repro_torch.core.plan import execute as t_execute, plan as t_plan
from repro_torch.core.substrat import SubStratConfig, build_subset, substrat
from repro_torch.obs import trace as t_trace
from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split

AUTOML = dict(n_trials=6, rungs=(5, 10), seed=6)     # samples no MLP at this size
FT = dict(n_trials=4, rungs=(10,), seed=6)


@pytest.fixture(scope="module")
def data():
    X, y = make_dataset(PAPER_DATASETS["D3"], scale=0.1)
    return train_test_split(X, y)


def test_execute_end_to_end_on_cpu(data):
    X, y, Xt, yt = data
    sink = []
    p = t_plan("gen_dst", cfg=TG.GenDSTConfig(psi=3, phi=8), sub_automl=TCfg(**AUTOML),
               ft_automl=TCfg(**FT))
    res = t_execute(p, X, y, X_test=Xt, y_test=yt, seed=1, trace_sink=sink, device="cpu")
    assert set(res.times) == {"factorize_s", "gen_dst_s", "automl_sub_s", "fine_tune_s"}
    # the four phase spans are the roots, in order; the layers' spans nest under them
    roots = [s for s in sink if s["parent_id"] is None]
    assert [s["name"] for s in roots] == ["factorize", "gen_dst", "sub_automl", "fine_tune"]
    assert np.isfinite(res.dst_fitness) and res.dst_fitness <= 0
    assert res.final.spec.family == res.intermediate.spec.family
    assert 0.0 <= res.final.test_acc <= 1.0 and res.strategy == "gen_dst"
    # SubStrat-NF: no fine-tune, M' scored on the test set's DST columns
    nf = substrat(X, y, seed=1, X_test=Xt, y_test=yt, device="cpu",
                  config=SubStratConfig(gen=TG.GenDSTConfig(psi=2, phi=8), fine_tune=False,
                                        sub_automl=TCfg(**AUTOML)))
    assert nf.final is not nf.intermediate and 0.0 <= nf.final.test_acc <= 1.0
    with pytest.raises(ValueError, match="unknown subset strategy"):
        t_plan("no_such_strategy")


def test_build_subset_patches_missing_classes():
    X = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.array([0] * 18 + [1, 2])
    Xs, ys = build_subset(X, y, np.arange(6), np.array([1]), patch_seed=3)
    assert set(ys) == {0, 1, 2} and Xs.shape == (8, 1)
    again = build_subset(X, y, np.arange(6), np.array([1]), patch_seed=3)
    np.testing.assert_array_equal(again[0], Xs)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", ["loop", "batched"])
def test_same_subset_same_families(data, backend, seed):
    X, y, Xt, yt = data
    dst = JG.gen_dst(jax.random.key(seed), j_factorize(X, y), None, None,
                     JG.GenDSTConfig(psi=3, phi=8))

    def jax_subset(key, coded, n, m):
        return dst

    def port_subset(generator, coded, n, m):
        return types.SimpleNamespace(row_idx=np.asarray(dst.row_idx),
                                     col_mask=np.asarray(dst.col_mask),
                                     fitness=float(dst.fitness))

    ref = j_execute(j_plan(jax_subset, sub_automl=JCfg(**AUTOML), ft_automl=JCfg(**FT),
                           backend=backend),
                    X, y, key=jax.random.key(seed), X_test=Xt, y_test=yt)
    out = t_execute(t_plan(port_subset, sub_automl=TCfg(**AUTOML), ft_automl=TCfg(**FT),
                           backend=backend),
                    X, y, seed=seed, X_test=Xt, y_test=yt, device="cpu")
    np.testing.assert_array_equal(out.row_idx, ref.row_idx)
    np.testing.assert_array_equal(out.col_idx, ref.col_idx)
    assert out.intermediate.spec.family == ref.intermediate.spec.family
    assert out.final.spec.family == ref.final.spec.family
    assert abs(out.final.test_acc - ref.final.test_acc) <= 2.0 / len(yt)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend", ["loop", "batched"])
def test_nf_same_subset_same_test_accuracy(data, backend, seed):
    """SubStrat-NF (no fine-tune; M' scored on the test set's DST columns by
    ``nf_test_eval``) on the same subset: the same family, and the same test
    accuracy within 1e-6."""
    X, y, Xt, yt = data
    dst = JG.gen_dst(jax.random.key(seed), j_factorize(X, y), None, None,
                     JG.GenDSTConfig(psi=3, phi=8))

    def jax_subset(key, coded, n, m):
        return dst

    def port_subset(generator, coded, n, m):
        return types.SimpleNamespace(row_idx=np.asarray(dst.row_idx),
                                     col_mask=np.asarray(dst.col_mask),
                                     fitness=float(dst.fitness))

    ref = j_execute(j_plan(jax_subset, fine_tune=False, sub_automl=JCfg(**AUTOML),
                           backend=backend),
                    X, y, key=jax.random.key(seed), X_test=Xt, y_test=yt)
    out = t_execute(t_plan(port_subset, fine_tune=False, sub_automl=TCfg(**AUTOML),
                           backend=backend),
                    X, y, seed=seed, X_test=Xt, y_test=yt, device="cpu")
    assert "fine_tune_s" not in out.times and "fine_tune_s" not in ref.times
    assert out.final.spec.family == ref.final.spec.family
    assert out.final.spec.family == out.intermediate.spec.family
    assert abs(out.final.test_acc - ref.final.test_acc) <= 1e-6


# ---------------------------------------------------------------------------
# the spans of one job (obs/trace.collect inside execute and automl_fit)
# ---------------------------------------------------------------------------


def _children(sink, parent):
    """Names of ``parent``'s child spans, in start order."""
    kids = [s for s in sink if s["parent_id"] == parent["span_id"]]
    return [s["name"] for s in sorted(kids, key=lambda s: s["t0"])]


def test_execute_records_each_layers_spans(data):
    X, y, Xt, yt = data
    sink = []
    psi = 3
    res = t_execute(t_plan("gen_dst", cfg=TG.GenDSTConfig(psi=psi, phi=8),
                           sub_automl=TCfg(**AUTOML), ft_automl=TCfg(**FT)),
                    X, y, X_test=Xt, y_test=yt, seed=1, trace_sink=sink, device="cpu")
    assert set(res.times) == {"factorize_s", "gen_dst_s", "automl_sub_s", "fine_tune_s"}
    assert len({s["span_id"] for s in sink}) == len(sink)
    assert len({s["trace_id"] for s in sink}) == 1
    phase = {s["name"]: s for s in sink if s["parent_id"] is None}
    assert list(phase) == ["factorize", "gen_dst", "sub_automl", "fine_tune"]
    for name, key in (("factorize", "factorize_s"), ("gen_dst", "gen_dst_s"),
                      ("sub_automl", "automl_sub_s"), ("fine_tune", "fine_tune_s")):
        assert res.times[key] == phase[name]["t1"] - phase[name]["t0"]

    assert _children(sink, phase["factorize"]) == ["factorize.host", "factorize.copy",
                                                   "factorize.device"]
    assert _children(sink, phase["gen_dst"]) == (["gen_dst.init"] + ["gen_dst.generation"] * psi
                                                 + ["gen_dst.to_host"])
    gens = [s for s in sink if s["name"] == "gen_dst.generation"]
    assert sorted(s["attrs"]["gen"] for s in gens) == list(range(psi))
    for name, result in (("sub_automl", res.intermediate), ("fine_tune", res.final)):
        rungs = [s for s in sink if s["name"] == "automl.rung"
                 and s["parent_id"] == phase[name]["span_id"]]
        assert _children(sink, phase[name]) == (["automl.init"] + ["automl.rung"] * len(rungs)
                                                + ["automl.result"])
        assert [s["attrs"]["rung"] for s in rungs] == list(range(len(rungs)))
        assert result.rung_times == [s["t1"] - s["t0"] for s in rungs]
        for r in rungs:
            assert _children(sink, r) == ["automl.rung.prep", "automl.rung.issue",
                                          "automl.rung.wait"]
        # the pass keeps its own spans: the same records the job's sink holds
        ids = {s["span_id"] for s in result.spans}
        assert all(any(s is t for t in sink) for s in result.spans)
        assert {s["span_id"] for s in sink if s["parent_id"] == phase[name]["span_id"]} <= ids
    # every span lies inside its parent
    by_id = {s["span_id"]: s for s in sink}
    for s in sink:
        if s["parent_id"] is not None:
            p = by_id[s["parent_id"]]
            assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"]
    assert "  gen_dst.generation" in t_trace.render_timeline(sink)


@pytest.mark.parametrize("backend", ["loop", "batched"])
def test_adam_steps_count_the_steps_adam_train_runs(data, backend, monkeypatch):
    """``adam_steps`` summed over the job's spans equals the steps
    ``models.adam_train`` ran, counted by a wrapper; ``trial_steps`` equals
    the steps times the trials each call trained."""
    X, y, Xt, yt = data
    ran = []

    def counting(adam_train):
        def wrapped(loss_fn, params0, lr, epochs, n_steps=None):
            steps = (epochs if n_steps is None or isinstance(n_steps, torch.Tensor)
                     else min(epochs, int(n_steps)))
            ran.append((steps, lr.numel() if isinstance(lr, torch.Tensor) else 1))
            return adam_train(loss_fn, params0, lr, epochs, n_steps)
        return wrapped

    monkeypatch.setattr(t_models, "adam_train", counting(t_models.adam_train))
    monkeypatch.setattr(t_batched, "adam_train", counting(t_batched.adam_train))
    sink = []
    t_execute(t_plan("gen_dst", cfg=TG.GenDSTConfig(psi=2, phi=8), backend=backend,
                     sub_automl=TCfg(**AUTOML), ft_automl=TCfg(**FT)),
              X, y, X_test=Xt, y_test=yt, seed=2, trace_sink=sink, device="cpu")
    issued = [s["attrs"] for s in sink if "adam_steps" in s["attrs"]]
    assert {s["name"] for s in sink if "adam_steps" in s["attrs"]} == {"automl.rung.issue"}
    assert sum(a["adam_steps"] for a in issued) == sum(st for st, _ in ran) > 0
    assert sum(a["trial_steps"] for a in issued) == sum(st * t for st, t in ran)
    if backend == "loop":
        assert all(a["adam_steps"] == a["trial_steps"] for a in issued)


def test_bare_automl_fit_keeps_its_spans_in_a_trace_of_its_own(data):
    X, y, _, _ = data
    a = t_automl_fit(X, y, config=TCfg(**AUTOML), device="cpu")
    b = t_automl_fit(X, y, config=TCfg(**AUTOML), device="cpu")
    names = [s["name"] for s in a.spans if s["parent_id"] is None]
    assert names[0] == "automl.init" and names[-1] == "automl.result"
    assert names.count("automl.rung") == len(a.rung_times) == len(AUTOML["rungs"])
    assert len({s["trace_id"] for s in a.spans}) == 1
    assert a.spans[0]["trace_id"] != b.spans[0]["trace_id"]
    assert a.rung_times == [s["t1"] - s["t0"] for s in a.spans if s["name"] == "automl.rung"]


def test_a_workers_reply_spans_are_unchanged_inside_a_collect(data):
    """The worker's ``deserialize``/``eval``/``serialize`` legs keep their
    pure ids under the dispatch span, whether or not the caller collects
    spans, and nothing of them lands in a collecting sink."""
    X, y, _, _ = data
    state = t_search_init(X, y, config=TCfg(**AUTOML), device="cpu")
    tt = t_trace.span_id("substrat-tasks", "0")
    payload = t_wire.dumps({"kind": "rung",
                            "cohorts": [t_worker.cohort_payload(t_search_trial_cohort(state))]},
                           kind="task", trace=t_trace.child_ctx(tt, "dispatch"))
    plain = t_worker.handle_eval(0, 3, payload, attempt=1, device="cpu")
    outer = []
    with t_trace.collect(outer):
        inside = t_worker.handle_eval(0, 3, payload, attempt=1, device="cpu")
    assert plain[0] == inside[0] == "done" and outer == []
    for reply in (plain, inside):
        spans = reply[-1]
        assert [s["name"] for s in spans] == ["deserialize", "eval", "serialize"]
        assert [s["span_id"] for s in spans] == [t_trace.span_id(tt, n, 1)
                                                 for n in ("deserialize", "eval", "serialize")]
        assert all(s["parent_id"] == t_trace.span_id(tt, "dispatch", 1) for s in spans)
        assert all(s["attrs"] == {"worker": 3} and s["trace_id"] == tt for s in spans)
