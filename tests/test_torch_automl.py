"""The port's AutoML loop backend against the reference's loop backend, on the CPU.

The spec sampling and the train/val split run the same numpy calls, so they
are identical.  Per-trial validation accuracies agree within 2/N_val (the
float32 training trajectories differ in summation order; a prediction may
flip near the decision boundary).  The MLP starts from the reference's own
initial params, injected through ``convert.params_from_numpy``, since torch
cannot replay threefry draws.  The winner spec is equal.  Trained params
of one trial agree within rtol 2e-4, atol 2e-5 (12 float32 Adam steps).
"""
import jax
import numpy as np
import pytest
import torch

import repro.automl.engine as JE
import repro.automl.models as JM
import repro_torch.automl.engine as TE
import repro_torch.automl.models as TM
from repro_torch.convert import params_from_numpy
from _torch_port import np_

CFG_J = JE.AutoMLConfig(n_trials=7, rungs=(6, 12), seed=7, backend="loop")
CFG_T = TE.AutoMLConfig(n_trials=7, rungs=(6, 12), seed=7,   # samples all 5 families
                        backend="loop")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    N = 360
    y = rng.integers(0, 3, N)
    X = np.column_stack([
        y * 1.2 + rng.normal(0, 1.0, N),
        -y * 0.8 + rng.normal(0, 1.0, N),
        rng.normal(0, 1, N) * 3.0,
        rng.integers(0, 4, N),
    ]).astype(np.float32)
    return X[:300], y[:300], X[300:], y[300:]


def _spec_tuple(s):
    return (s.preproc, s.feature_frac, s.family, s.hp)


def _jax_mlp_init(spec, tid, rung, d, c):
    """The reference loop backend's initial MLP params for this trial."""
    if spec.family != "mlp":
        return None
    tree = JM.FAMILIES["mlp"].init(JE._trial_key(CFG_J.seed, tid, rung), d, c, dict(spec.hp))
    return params_from_numpy("mlp", jax.tree.map(np.asarray, tree), device="cpu")


def test_sampling_and_split_identical(data):
    X, y, _, _ = data
    sj = JE.search_init(X, y, config=CFG_J)
    st = TE.search_init(X, y, config=CFG_T, device="cpu")
    assert [_spec_tuple(s) for s in st.specs] == [_spec_tuple(s) for s in sj.specs]
    for k in ("X_tr", "y_tr", "X_val", "y_val"):
        np.testing.assert_array_equal(st.ctx[k], sj.ctx[k])
    np.testing.assert_array_equal(st.classes, sj.classes)
    rj = JE.search_init(X, y, config=CFG_J, restrict_family="gnb")
    rt = TE.search_init(X, y, config=CFG_T, restrict_family="gnb", device="cpu")
    assert [_spec_tuple(s) for s in rt.specs] == [_spec_tuple(s) for s in rj.specs]


def test_search_trials_and_winner_match(data):
    X, y, Xt, yt = data
    rj = JE.automl_fit(X, y, config=CFG_J, X_test=Xt, y_test=yt)
    rt = TE.automl_fit(X, y, config=CFG_T, X_test=Xt, y_test=yt, device="cpu",
                       init_provider=_jax_mlp_init)
    n_val = max(1, int(CFG_T.val_frac * len(y)))
    assert [_spec_tuple(s) for s, _ in rt.trials] == [_spec_tuple(s) for s, _ in rj.trials]
    fams = {s.family for s, _ in rt.trials}
    assert {"logreg", "linear_svm", "gnb", "centroid", "mlp"} <= fams
    for (s, at), (_, aj) in zip(rt.trials, rj.trials):
        assert abs(at - aj) <= 2.0 / n_val, (s, at, aj)
    assert _spec_tuple(rt.spec) == _spec_tuple(rj.spec)
    assert abs(rt.test_acc - rj.test_acc) <= 2.0 / len(yt)


@pytest.mark.parametrize("family", ["logreg", "linear_svm", "gnb", "centroid", "mlp"])
def test_each_family_trains_like_reference(data, family):
    X, y, Xt, yt = data
    hp = {k: v[0] for k, v in JM.FAMILIES[family].hp_grid.items()}
    key = jax.random.key(0)
    pj = JM.train_model(key, jax.numpy.asarray(X), jax.numpy.asarray(y), family, 3, hp, 12)
    init = None
    if family == "mlp":
        tree = JM.FAMILIES["mlp"].init(key, X.shape[1], 3, hp)
        init = params_from_numpy("mlp", jax.tree.map(np.asarray, tree), device="cpu")
    pt = TM.train_model(torch.Generator(), torch.as_tensor(X), torch.as_tensor(y), family, 3,
                        hp, 12, init_params=init)
    for lj, lt in zip(jax.tree.leaves(pj), TM._leaves(pt)):
        np.testing.assert_allclose(np_(lt), np.asarray(lj), rtol=2e-4, atol=2e-5)
    acc_j = JM.accuracy(pj, jax.numpy.asarray(Xt), jax.numpy.asarray(yt), family)
    acc_t = TM.accuracy(pt, torch.as_tensor(Xt), torch.as_tensor(yt), family)
    assert abs(acc_t - acc_j) <= 2.0 / len(yt)


@pytest.mark.parametrize("n_steps", [None, 3])
def test_adam_step_mask_matches_reference(data, n_steps):
    """``n_steps`` masks the steps past it: the result is an n_steps-long run
    of the reference's Adam (rtol 1e-5: float32 on both sides)."""
    X, y, _, _ = data
    hp = {"lr": 0.1, "l2": 1e-4}
    p0 = {"w": np.zeros((4, 3), np.float32), "b": np.zeros(3, np.float32)}
    Xj, yj = jax.numpy.asarray(X), jax.numpy.asarray(y)
    grad_fn = jax.grad(lambda p: JM.FAMILIES["logreg"].loss(p, Xj, yj, 3, hp))
    ref = JM.adam_train(grad_fn, jax.tree.map(jax.numpy.asarray, p0), hp["lr"], 8,
                        n_steps=None if n_steps is None else jax.numpy.int32(n_steps))
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    out = TM.adam_train(lambda p: TM.FAMILIES["logreg"].loss(p, Xt, yt, 3, hp),
                        params_from_numpy("logreg", p0, device="cpu"), hp["lr"], 8,
                        n_steps=n_steps)
    for k in ("w", "b"):
        np.testing.assert_allclose(np_(out[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)


def test_sh_promote_stable_top_k():
    acc = np.array([0.5, 0.9, 0.9, 0.1, 0.9], np.float32)
    for frac in (0.34, 0.5, 0.01):
        np.testing.assert_array_equal(TE.sh_promote(acc, frac),
                                      np.asarray(JE.sh_promote(acc, frac)))


def test_params_from_numpy_round_trip():
    rng = np.random.default_rng(0)
    tree = {"w": rng.random((3, 2)), "b": rng.random(2)}
    p = params_from_numpy("logreg", tree, device="cpu")
    assert p["w"].dtype == torch.float32 and p["w"].shape == (3, 2)
    with pytest.raises(ValueError):
        params_from_numpy("tree", tree, device="cpu")
