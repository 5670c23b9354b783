"""The port's comparison harness (``repro_torch.launch.compare``) against the
JAX package's ``benchmarks/common.py``, on the CPU.

- The quick budgets, every field of ``substrat_config()`` and each of the
  nine methods' plans (strategy, options, fine-tune, n, m, both AutoML
  budgets) equal the reference's exactly.  The port has no
  ``GenDSTConfig.backend`` and no ``SubStratConfig.dst_backend`` (the
  device picks the kernels); those are the only fields the reference has
  beyond the port's.
- ``run_dataset``'s split (what reaches Full-AutoML) is bit-equal to the
  reference's.
- The protocol: each distinct method's strategy runs once, untimed, in the
  order the methods are listed, seeded 0, before any method runs; each
  method runs with seed ``seed * 977 + 13``.  Counted through numpy subset
  strategies registered in both packages (as ``np_strategy_registered``
  does), which draw nothing: the same calls in each package.
- Values: with those strategies the subsets are equal, and the AutoML seed
  is one whose sampled population holds no MLP (the one model whose init
  the port draws with torch), so no draw of either package reaches a
  result: Full-AutoML's and each method's winner family are equal and their
  test accuracies within 2/N_test (``tests/test_torch_plan.py``'s bound,
  counted in predictions: float32 accuracies 2/N_test apart may differ by
  a hair more than 2/N_test).
- ``time_reduction`` and ``relative_accuracy`` follow the reference's
  formulas exactly.
"""
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import benchmarks.common as J  # noqa: E402
import repro.core.gen_dst as JG  # noqa: E402
import repro.core.substrat as JS  # noqa: E402
import repro_torch.core.gen_dst as TG  # noqa: E402
import repro_torch.core.substrat as TS  # noqa: E402
from _torch_port import j_np, t_np  # noqa: E402
from repro.core.strategies import STRATEGIES as J_STRATEGIES  # noqa: E402
from repro.core.strategies import register_strategy as j_reg  # noqa: E402
from repro_torch.core.strategies import STRATEGIES as T_STRATEGIES  # noqa: E402
from repro_torch.core.strategies import register_strategy as t_reg  # noqa: E402
from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split  # noqa: E402
from repro_torch.launch import compare as C  # noqa: E402

METHODS = ["SubStrat", "SubStrat-NF", "MC-100", "MC-100K", "MAB", "KM", "IG-Rand", "IG-KM",
           "ASP"]
AUTOML = dict(n_trials=6, rungs=(5, 10), seed=6)     # samples no MLP
FT = dict(n_trials=4, rungs=(10,), seed=6)


def _plain(x):
    """A config or plan as nested plain values, over the port's fields."""
    if isinstance(x, (TG.GenDSTConfig, JG.GenDSTConfig)):
        return {f: _plain(getattr(x, f)) for f in TG.GenDSTConfig._fields}
    if isinstance(x, (TS.SubStratConfig, JS.SubStratConfig)):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(TS.SubStratConfig)}
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    return x


def test_only_the_backend_fields_are_the_references_alone():
    assert set(JG.GenDSTConfig._fields) - set(TG.GenDSTConfig._fields) == {"backend"}
    assert set(TG.GenDSTConfig._fields) <= set(JG.GenDSTConfig._fields)
    t_fields = {f.name for f in dataclasses.fields(TS.SubStratConfig)}
    j_fields = {f.name for f in dataclasses.fields(JS.SubStratConfig)}
    assert j_fields - t_fields == {"dst_backend"} and t_fields <= j_fields


@pytest.mark.parametrize("name", ["QUICK_AUTOML", "QUICK_FT", "QUICK_GEN"])
def test_quick_budgets_equal_the_references(name):
    assert _plain(getattr(C, name)) == _plain(getattr(J, name))


@pytest.mark.parametrize("kw", [{}, {"automl_backend": "loop"}, {"fine_tune": False, "n": 30}])
def test_substrat_config_equals_the_references(kw):
    assert _plain(C.substrat_config(**kw)) == _plain(J.substrat_config(**kw))
    assert J.substrat_config(**kw).dst_backend is None


def test_baseline_strategies_equal_the_references():
    assert C.BASELINE_STRATEGIES == J.BASELINE_STRATEGIES
    assert list(C.BASELINE_STRATEGIES) == list(J.BASELINE_STRATEGIES)


@pytest.mark.parametrize("method", METHODS)
def test_method_plan_equals_the_references(method):
    for kw in ({}, {"automl_backend": "loop"}):
        got = C.method_plan(method, C.substrat_config(**kw))
        want = J.method_plan(method, J.substrat_config(**kw))
        assert _plain(got) == _plain(want)
        assert [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)]


def _flips(acc_a, acc_b, n_test) -> int:
    """Test predictions by which two float32 accuracies differ."""
    return abs(round(acc_a * n_test) - round(acc_b * n_test))


class _Stop(Exception):
    pass


def test_run_dataset_split_is_bit_equal_to_the_references(monkeypatch):
    seen = {}

    def capture(pkg):
        def automl_fit(X, y, *, X_test=None, y_test=None, **kw):
            seen[pkg] = (X, y, X_test, y_test)
            raise _Stop
        return automl_fit

    monkeypatch.setattr(J, "automl_fit", capture("jax"))
    monkeypatch.setattr(C, "automl_fit", capture("torch"))
    spec = PAPER_DATASETS["D6"]
    for run in (J.run_dataset, lambda s, **kw: C.run_dataset(s, device="cpu", **kw)):
        with pytest.raises(_Stop):
            run(spec, scale=0.05, seed=3)
    for got, want in zip(seen["torch"], seen["jax"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def counted_strategies(monkeypatch):
    """Two numpy strategies registered in both packages, each call logged,
    and methods "NP-A" and "NP-B" naming them in both harnesses.  The port's
    strategy sleeps 0.3 s when its generator is seeded 0 (the warm-up)."""
    log = {"jax": [], "torch": []}

    def j_fn(name):
        def fn(key, coded, n, m):
            log["jax"].append(name)
            return j_np(key, coded, n, m)
        return fn

    def t_fn(name):
        def fn(generator, coded, n, m):
            log["torch"].append((name, generator.initial_seed()))
            if generator.initial_seed() == 0:
                time.sleep(0.3)
            return t_np(generator, coded, n, m)
        return fn

    for name in ("np_a", "np_b"):
        j_reg(name, j_fn(name), overwrite=True)
        t_reg(name, t_fn(name), overwrite=True)
    for mod in (J, C):
        monkeypatch.setitem(mod.BASELINE_STRATEGIES, "NP-A", ("np_a", ()))
        monkeypatch.setitem(mod.BASELINE_STRATEGIES, "NP-B", ("np_b", ()))
    try:
        yield log
    finally:
        for name in ("np_a", "np_b"):
            del J_STRATEGIES[name], T_STRATEGIES[name]


def test_run_dataset_protocol_values_and_formulas(counted_strategies, monkeypatch):
    log = counted_strategies
    ref = {"full": [], "methods": []}

    def record(key, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            ref[key].append(out)
            return out
        return wrapped

    monkeypatch.setattr(J, "automl_fit", record("full", J.automl_fit))
    monkeypatch.setattr(J, "execute", record("methods", J.execute))
    methods = ["NP-A", "NP-B", "NP-A"]
    kw = dict(scale=0.1, seed=2, methods=methods)
    j_full, j_out = J.run_dataset(
        PAPER_DATASETS["D3"], full_cfg=J.AutoMLConfig(**AUTOML),
        sub_cfg=J.substrat_config(sub_automl=J.AutoMLConfig(**AUTOML),
                                  ft_automl=J.AutoMLConfig(**FT)), **kw)
    full, out = C.run_dataset(
        PAPER_DATASETS["D3"], full_cfg=C.AutoMLConfig(**AUTOML),
        sub_cfg=C.substrat_config(sub_automl=C.AutoMLConfig(**AUTOML),
                                  ft_automl=C.AutoMLConfig(**FT)), device="cpu", **kw)

    # the warm-up: each distinct strategy once, in list order, seeded 0, first
    seed = 2 * 977 + 13
    assert log["torch"] == [("np_a", 0), ("np_b", 0), ("np_a", seed), ("np_b", seed),
                            ("np_a", seed)]
    assert sorted(log["jax"][:2]) == ["np_a", "np_b"]
    assert log["jax"][2:] == ["np_a", "np_b", "np_a"]
    assert [r.method for r in out] == [r.method for r in j_out] == methods

    X, y = make_dataset(PAPER_DATASETS["D3"], scale=0.1)
    n_test = len(train_test_split(X, y, 0.2, seed=2)[3])
    assert (full.method, full.time_reduction, full.relative_accuracy) == (
        "Full-AutoML", 0.0, 1.0)
    assert full.result.spec.family == ref["full"][0].spec.family
    assert _flips(full.test_acc, j_full.test_acc, n_test) <= 2
    for r, jr, jres in zip(out, j_out, ref["methods"]):
        np.testing.assert_array_equal(r.result.row_idx, jres.row_idx)
        np.testing.assert_array_equal(r.result.col_idx, jres.col_idx)
        assert r.result.final.spec.family == jres.final.spec.family
        assert _flips(r.test_acc, jr.test_acc, n_test) <= 2
        assert r.result.times["gen_dst_s"] < 0.3          # the warm-up was not timed
        assert r.time_s == r.result.total_time_s
        assert r.time_reduction == 1.0 - r.time_s / max(full.time_s, 1e-9)
        assert r.relative_accuracy == r.test_acc / max(full.test_acc, 1e-9)
        assert r.launches == {"masked_histogram": 0, "fused_delta_fitness": 0,
                              "flash_attention": 0, "ssd_scan": 0}
    assert full.launches == out[0].launches
