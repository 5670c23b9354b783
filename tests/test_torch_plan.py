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

import repro.core.gen_dst as JG
import repro_torch.core.gen_dst as TG
from repro.automl.engine import AutoMLConfig as JCfg
from repro.core.measures import factorize as j_factorize
from repro.core.plan import execute as j_execute, plan as j_plan
from repro_torch.automl.engine import AutoMLConfig as TCfg
from repro_torch.core.plan import execute as t_execute, plan as t_plan
from repro_torch.core.substrat import SubStratConfig, build_subset, substrat
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
    assert [s["name"] for s in sink] == ["factorize", "gen_dst", "sub_automl", "fine_tune"]
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
