"""The port's batched cohort AutoML backend against the JAX package, on the CPU.
Its rung on a card is ``tests/test_torch_tabular_card.py``'s.

Tolerances:
* masked losses within rel 1e-5, abs 1e-6 and masked fits within 1e-5 of the
  reference's (its own tolerances, ``tests/test_hetero_merge.py``); masked
  accuracies within 1e-6;
* ``adam_train`` with per-trial ``lr`` and a mixed ``n_steps`` tensor within
  rtol 1e-5, atol 1e-6 of the reference's vmapped ``adam_train`` (float32 on
  both sides); inside the port, a masked trial is bit-equal to its solo run;
* port against reference (batched on both sides): equal cohorts and
  positions, per-trial validation accuracy within 2/N_val (the float32
  trajectories differ in summation order, so a prediction may flip near the
  decision boundary), and the same winner spec.  The reference's MLP init is
  injected through ``init_provider``, since torch cannot replay threefry;
* port batched against port loop: the same winner and per-trial accuracy
  within 1e-6, as the reference holds its own two backends
  (``tests/test_automl_batched.py``); winner params within 1e-5;
* merged cohorts against solo runs inside the port: within 1e-6.

The merge tests' jobs have training splits whose row count is no multiple
of their class count.  Where a class holds exactly 1/C of the rows, the
hinge loss's gradient of its bias is exactly 0 at the zero init, both
packages compute it as float noise of either sign (+3.7e-9 against -2.2e-8
at 240 rows with 80 in class 1), and Adam turns that noise into a step of
up to ``lr`` whose sign decides a few predictions (ROADMAP.md, C3).  The
port's two backends agree there; the reference and the port need not.

Tiny configs (300 rows, 8 trials, rungs (4, 8)) keep the file near a minute
in one CPU process, most of it the reference compiling.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.automl.batched as JB
import repro.automl.engine as JE
import repro.automl.models as JM
import repro_torch.automl.batched as TB
import repro_torch.automl.engine as TE
import repro_torch.automl.models as TM
from _port_cases import AUTOML_CFG, AUTOML_SEED, automl_table
from _torch_port import np_
from repro_torch.convert import params_from_numpy

SEED = AUTOML_SEED
CFG = AUTOML_CFG


def _make(seed, N, d, C):
    r = np.random.default_rng(seed)
    y = r.integers(0, C, N)
    X = np.column_stack([y * 1.2 + r.normal(0, 0.9 + 0.1 * j, N) for j in range(d)])
    return X.astype(np.float32), y


@pytest.fixture(scope="module")
def data():
    return automl_table()


def _spec_tuple(s):
    return (s.preproc, s.feature_frac, s.family, s.hp)


def jax_mlp_init(seed):
    """An ``init_provider`` that hands the port the reference's MLP init."""
    def provider(spec, tid, rung, d, c):
        if spec.family != "mlp":
            return None
        tree = JM.FAMILIES["mlp"].init(JE._trial_key(seed, tid, rung), d, c, dict(spec.hp))
        return params_from_numpy("mlp", jax.tree.map(np.asarray, tree), device="cpu")
    return provider


def _states(X, y, seed, **kw):
    """The same search in both packages (batched), the port's MLP init
    injected from the reference's."""
    cfg = dict(CFG, seed=seed, **kw)
    sj = JE.search_init(X, y, config=JE.AutoMLConfig(**cfg, backend="batched"))
    st = TE.search_init(X, y, config=TE.AutoMLConfig(**cfg), device="cpu",
                        init_provider=jax_mlp_init(seed))
    return sj, st


def _assert_scored_close(got, ref, n_val, tol=None):
    """Per-trial (spec, accuracy) of two rung outputs: equal specs and
    positions, accuracies within ``tol`` (default 2/N_val)."""
    (scored_t, pos_t), (scored_j, pos_j) = got, ref
    assert pos_t == list(pos_j)
    assert [_spec_tuple(s[0]) for s in scored_t] == [_spec_tuple(s[0]) for s in scored_j]
    tol = 2.0 / n_val if tol is None else tol
    for st_, sj_ in zip(scored_t, scored_j):
        assert abs(st_[1] - float(sj_[1])) <= tol, (st_[0], st_[1], sj_[1])


# ---------------------------------------------------------------------------
# masked losses / fits / accuracy against the reference
# ---------------------------------------------------------------------------


def _pad_case(padded):
    r = np.random.default_rng(3)
    N, d, C = 40, 5, 3
    X = r.normal(0, 1, (N, d)).astype(np.float32)
    y = r.integers(0, C, N)
    if not padded:
        return X, y, np.ones(N, np.float32), np.zeros(C, np.float32), C
    Xp = np.pad(X, ((0, 17), (0, 4)))
    yp = np.pad(y, (0, 17))
    w = np.pad(np.ones(N, np.float32), (0, 17))
    cmask = np.where(np.arange(C + 2) < C, 0.0, JM.CLASS_MASK_NEG).astype(np.float32)
    return Xp, yp, w, cmask, C + 2


def _pad_params(family, params, padded):
    """The reference's init of shape (5, 3) embedded in the padded (9, 5)
    layout (extra features and classes zero)."""
    if not padded:
        return params
    if family == "mlp":
        L = len(params["layers"])
        return {"layers": [
            {"w": np.pad(l["w"], ((0, 4 if i == 0 else 0), (0, 2 if i == L - 1 else 0))),
             "b": np.pad(l["b"], (0, 2 if i == L - 1 else 0))}
            for i, l in enumerate(params["layers"])]}
    return {"w": np.pad(params["w"], ((0, 4), (0, 2))), "b": np.pad(params["b"], (0, 2))}


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("family", ["logreg", "linear_svm", "mlp"])
def test_masked_loss_matches_reference(family, padded):
    X, y, w, cmask, c = _pad_case(padded)
    fam = JM.FAMILIES[family]
    hp = {k: v[1] for k, v in fam.hp_grid.items()}
    r = np.random.default_rng(5)
    params = {"w": r.normal(0, 0.3, (5, 3)).astype(np.float32),
              "b": r.normal(0, 0.3, 3).astype(np.float32)}
    if family == "mlp":
        params = jax.tree.map(np.asarray, fam.init(jax.random.key(0), 5, 3, hp))
    params = _pad_params(family, params, padded)
    ref = JM.masked_loss(family, jax.tree.map(jax.numpy.asarray, params), X, y, w,
                         cmask, c, hp)
    t = torch.as_tensor
    got = TM.masked_loss(family, params_from_numpy(family, params, device="cpu"), t(X), t(y),
                         t(w), t(cmask), c, hp)
    assert float(got) == pytest.approx(float(ref), rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("family", ["gnb", "centroid"])
def test_masked_fit_and_accuracy_match_reference(family, padded):
    X, y, w, cmask, c = _pad_case(padded)
    hp = {k: v[1] for k, v in JM.FAMILIES[family].hp_grid.items()}
    ref = JM.masked_fit(family, X, y, w, cmask, c, hp)
    t = torch.as_tensor
    got = TM.masked_fit(family, t(X), t(y), t(w), t(cmask), c, hp)
    for k in ref:
        np.testing.assert_allclose(np_(got[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-5)
    acc_ref = float(JM.masked_accuracy(family, ref, X, y, w, cmask))
    acc_got = float(TM.masked_accuracy(family, got, t(X), t(y), t(w), t(cmask)))
    assert acc_got == pytest.approx(acc_ref, abs=1e-6)


# ---------------------------------------------------------------------------
# adam_train: per-trial lr and step mask, against the reference's vmap
# ---------------------------------------------------------------------------


def test_adam_per_trial_lr_and_step_mask_match_reference(data):
    X, y, _, _ = data
    budgets = np.array([2, 8, 5, 0], np.int32)
    lrs = np.array([0.3, 0.1, 0.03, 0.1], np.float32)
    l2s = np.array([0.0, 1e-4, 1e-2, 1e-4], np.float32)
    T, d = len(budgets), X.shape[1]
    Xj, yj = jax.numpy.asarray(X), jax.numpy.asarray(y)

    def one(lr, l2, n):
        hp = {"lr": lr, "l2": l2}
        grad_fn = jax.grad(lambda p: JM.FAMILIES["logreg"].loss(p, Xj, yj, 3, hp))
        p0 = JM.FAMILIES["logreg"].init(None, d, 3, {})
        return JM.adam_train(grad_fn, p0, lr, 8, n_steps=n)
    ref = jax.vmap(one)(lrs, l2s, budgets)

    Xt = torch.as_tensor(X).expand(T, *X.shape)
    yt = torch.as_tensor(y).expand(T, len(y))
    hp = {"lr": torch.as_tensor(lrs), "l2": torch.as_tensor(l2s)}
    p0 = {"w": torch.zeros((T, d, 3)), "b": torch.zeros((T, 3))}
    out = TM.adam_train(lambda p: TM.FAMILIES["logreg"].loss(p, Xt, yt, 3, hp), p0,
                        hp["lr"], 8, n_steps=torch.as_tensor(budgets, dtype=torch.int64))
    for k in ("w", "b"):
        np.testing.assert_allclose(np_(out[k]), np.asarray(ref[k]), rtol=1e-5, atol=1e-6)
    # inside the port, each masked trial equals its own solo run bit for bit
    for i, n in enumerate(budgets):
        hp1 = {"lr": float(lrs[i]), "l2": float(l2s[i])}
        solo = TM.adam_train(
            lambda p: TM.FAMILIES["logreg"].loss(p, Xt[0], yt[0], 3, hp1),
            {"w": torch.zeros((d, 3)), "b": torch.zeros(3)}, lrs[i].item(), int(n))
        np.testing.assert_array_equal(np_(out["w"][i]), np_(solo["w"]))


# ---------------------------------------------------------------------------
# one rung, both width regimes, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regime", ["pad", "split"])
def test_eval_rung_batched_matches_reference(data, monkeypatch, regime):
    X, y, _, _ = data
    # the split regime is the port's large-cohort regime: widths split and
    # the stacked products go trial by trial
    limit = 10 ** 6 if regime == "pad" else 0
    monkeypatch.setattr(JB, "WIDTH_PAD_MAX_ROWS", limit)
    monkeypatch.setattr(TB, "WIDTH_PAD_MAX_ROWS", limit)
    monkeypatch.setattr(TM, "STACKED_MATMUL_MAX_ROWS", limit)
    sj, st = _states(X, y, SEED)
    cohort_j, tids, epochs, _ = JE.search_cohort(sj)
    cohort_t, tids_t, _, _ = TE.search_cohort(st)
    assert tids == tids_t
    ref = JB.eval_rung_batched(cohort_j, tids, 0, epochs, sj.ctx, sj.out_of_budget, True)
    got = TB.eval_rung_batched(cohort_t, tids, 0, epochs, st.ctx, st.out_of_budget, True)
    _assert_scored_close(got, ref, len(st.ctx["y_val"]))
    # the regime decides how the three depth-2 MLPs (widths 128, 32, 128) group
    _, _, subbatches, _ = TB._rung_inputs(cohort_t, tids, 0, epochs, st.ctx)
    mlp_groups = sorted(desc.T for _i, desc, _g in subbatches if desc.family == "mlp")
    assert mlp_groups == ([3] if regime == "pad" else [1, 2])


def test_automl_fit_batched_matches_reference(data):
    X, y, Xt, yt = data
    rj = JE.automl_fit(X, y, config=JE.AutoMLConfig(**CFG, backend="batched"),
                       X_test=Xt, y_test=yt)
    rt = TE.automl_fit(X, y, config=TE.AutoMLConfig(**CFG), X_test=Xt, y_test=yt,
                       device="cpu", init_provider=jax_mlp_init(SEED))
    assert rt.backend == "batched" == rj.backend
    n_val = max(1, int(0.2 * len(y)))
    assert [_spec_tuple(s) for s, _ in rt.trials] == [_spec_tuple(s) for s, _ in rj.trials]
    for (s, at), (_, aj) in zip(rt.trials, rj.trials):
        assert abs(at - float(aj)) <= 2.0 / n_val, (s, at, aj)
    assert _spec_tuple(rt.spec) == _spec_tuple(rj.spec)
    assert abs(rt.test_acc - rj.test_acc) <= 2.0 / len(yt)


# ---------------------------------------------------------------------------
# port batched against port loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("restrict", [None, "mlp", "gnb"])
def test_batched_equals_loop_in_port(data, restrict):
    X, y, Xt, yt = data
    cfg = dict(CFG) if restrict is None else dict(n_trials=16, rungs=(8,), seed=1)
    out = {b: TE.automl_fit(X, y, config=TE.AutoMLConfig(**cfg, backend=b),
                            restrict_family=restrict, X_test=Xt, y_test=yt, device="cpu")
           for b in ("loop", "batched")}
    loop, bat = out["loop"], out["batched"]
    assert bat.spec == loop.spec and bat.n_trials == loop.n_trials
    assert [s for s, _ in bat.trials] == [s for s, _ in loop.trials]
    np.testing.assert_allclose([v for _, v in bat.trials], [v for _, v in loop.trials],
                               atol=1e-6)
    # lazy winner params come back unpadded, at the loop backend's shapes
    lp, bp = TM._leaves(loop.params), TM._leaves(bat.params)
    assert [x.shape for x in bp] == [x.shape for x in lp]
    for a, b in zip(bp, lp):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-5, atol=1e-5)
    assert bat.test_acc == pytest.approx(loop.test_acc, abs=1e-6)
    if restrict is not None:
        assert {s.family for s, _ in bat.trials} == {restrict}


# ---------------------------------------------------------------------------
# cross-job merges against the reference and against solo runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shapes", ["exact", "hetero"])
def test_eval_rung_cohorts_matches_reference_and_solo(shapes):
    # training splits of 241, 177 and 209 rows (module docstring)
    jobs = ([((301, 5, 3), 4), ((301, 5, 3), 5)] if shapes == "exact"
            else [((301, 5, 3), 4), ((221, 4, 2), 5), ((261, 6, 3), 6)])
    pairs = [_states(*_make(10 + i, *s), seed) for i, (s, seed) in enumerate(jobs)]
    ref = JB.eval_rung_cohorts([JE.search_trial_cohort(sj) for sj, _ in pairs])
    got = TB.eval_rung_cohorts([TE.search_trial_cohort(st) for _, st in pairs])
    for (sj, st), g, r in zip(pairs, got, ref):
        _assert_scored_close(g, r, len(st.ctx["y_val"]))
        cohort, tids, epochs, _ = TE.search_cohort(st)
        solo = TB.eval_rung_batched(cohort, tids, 0, epochs, st.ctx, st.out_of_budget, False)
        _assert_scored_close(g, solo, len(st.ctx["y_val"]), tol=1e-6)


def test_eval_trial_megabatch_matches_reference_and_solo():
    """Job A one rung ahead of job B, both in one megabatch with mixed step
    budgets and different shapes."""
    # training splits of 241 and 193 rows (module docstring)
    (sjA, stA), (sjB, stB) = (_states(*_make(20, 301, 5, 3), 7),
                              _states(*_make(21, 241, 4, 2), 8))
    for sj, st in ((sjA, stA),):
        JE.search_eval_rung(sj)
        TE.search_eval_rung(st)
        assert [_spec_tuple(sj.specs[i]) for i in sj.alive_ids] == \
            [_spec_tuple(st.specs[i]) for i in st.alive_ids]
    tcA, tcB = TE.search_trial_cohort(stA), TE.search_trial_cohort(stB)
    assert set(tcA.trial_rungs) == {1} and set(tcB.trial_rungs) == {0}
    assert tcA.trial_steps != tcB.trial_steps
    ref = JB.eval_trial_megabatch([JE.search_trial_cohort(sjA), JE.search_trial_cohort(sjB)])
    got = TB.eval_trial_megabatch([tcA, tcB])
    for st, tc, g, r in zip((stA, stB), (tcA, tcB), got, ref):
        _assert_scored_close(g, r, len(st.ctx["y_val"]))
        solo = TB.eval_rung_batched(tc.specs, tc.tids, tc.rung_i, tc.epochs, st.ctx,
                                    st.out_of_budget, False)
        _assert_scored_close(g, solo, len(st.ctx["y_val"]), tol=1e-6)


def test_eval_rung_cohorts_refuses_mixed_rungs(data):
    X, y, _, _ = data
    _, stA = _states(X, y, SEED)
    _, stB = _states(X, y, SEED + 1)
    TE.search_eval_rung(stA)
    with pytest.raises(ValueError, match="must share"):
        TB.eval_rung_cohorts([TE.search_trial_cohort(stA), TE.search_trial_cohort(stB)])


# ---------------------------------------------------------------------------
# the budget path, rung cursors, the registry and the overrides
# ---------------------------------------------------------------------------


def test_budget_stops_between_subbatches(data):
    """With the budget spent at once, rung 0 scores exactly its first
    sub-batch (one is always scored) and the search stops, in both
    packages."""
    X, y, Xt, yt = data
    cfg = dict(CFG, time_budget_s=1e-9)
    rj = JE.automl_fit(X, y, config=JE.AutoMLConfig(**cfg, backend="batched"))
    rt = TE.automl_fit(X, y, config=TE.AutoMLConfig(**cfg), X_test=Xt, y_test=yt,
                       device="cpu", init_provider=jax_mlp_init(SEED))
    st = TE.search_init(X, y, config=TE.AutoMLConfig(**cfg), device="cpu")
    cohort, tids, epochs, _ = TE.search_cohort(st)
    _, _, subbatches, _ = TB._rung_inputs(cohort, tids, 0, epochs, st.ctx)
    first = subbatches[0][0]
    assert 1 <= rt.n_trials == len(first) < len(cohort)
    assert [_spec_tuple(s) for s, _ in rt.trials] == [_spec_tuple(cohort[i]) for i in first]
    assert [_spec_tuple(s) for s, _ in rt.trials] == [_spec_tuple(s) for s, _ in rj.trials]
    n_val = len(st.ctx["y_val"])
    for (_, at), (_, aj) in zip(rt.trials, rj.trials):
        assert abs(at - float(aj)) <= 2.0 / n_val
    assert 0.0 <= rt.test_acc <= 1.0


def test_trial_rung_advances_for_survivors_only(data):
    X, y, _, _ = data
    _, st = _states(X, y, SEED)
    assert st.trial_rung == {i: 0 for i in range(len(st.specs))}
    TE.search_eval_rung(st)
    survivors = set(st.alive_ids)
    assert 1 <= len(survivors) < len(st.specs)
    assert st.trial_rung == {i: 1 if i in survivors else 0 for i in range(len(st.specs))}
    tc = TE.search_trial_cohort(st)
    assert tc.trial_rungs == (1,) * len(survivors)
    assert tc.trial_steps == (CFG["rungs"][1],) * len(survivors)


def test_backend_registry():
    assert TE.AutoMLConfig().backend == "batched"
    assert {"batched", "loop"} <= set(TE.available_backends())
    with pytest.raises(ValueError, match="available backends: .*batched.*loop"):
        TE.get_backend("nope")
    with pytest.raises(ValueError, match="already registered"):
        TE.register_backend("loop", TE.BACKENDS["loop"])
    X, y = _make(0, 40, 3, 2)
    with pytest.raises(ValueError, match="unknown AutoML backend 'nope'"):
        TE.automl_fit(X, y, config=TE.AutoMLConfig(backend="nope"), device="cpu")


@pytest.fixture
def spy_backend():
    """A registered backend that records the data shape of every rung and
    runs the loop backend."""
    seen = []

    def spy(cohort, tids, rung_i, epochs, ctx, out_of_budget, collect_params=True):
        seen.append(ctx["X_tr"].shape)
        return TE._eval_rung_loop(cohort, tids, rung_i, epochs, ctx, out_of_budget,
                                  collect_params)
    TE.register_backend("spy", spy)
    yield seen
    del TE.BACKENDS["spy"]


def test_plan_and_config_overrides_reach_both_passes(spy_backend):
    from repro_torch.core.gen_dst import GenDSTConfig
    from repro_torch.core.plan import Plan, execute, plan, plan_from_config
    from repro_torch.core.substrat import SubStratConfig, substrat
    sub, ft = TE.AutoMLConfig(n_trials=4, rungs=(2, 3)), TE.AutoMLConfig(n_trials=4, rungs=(2,))
    p = plan("gen_dst", cfg=GenDSTConfig(psi=2, phi=4), sub_automl=sub, ft_automl=ft,
             backend="loop")
    assert p.resolved_sub_automl().backend == p.resolved_ft_automl().backend == "loop"
    assert Plan().resolved_sub_automl().backend == "batched"
    with pytest.raises(ValueError, match="available backends"):
        Plan(backend="nope")
    with pytest.raises(ValueError, match="available backends"):
        SubStratConfig(automl_backend="nope")
    cfg = SubStratConfig(gen=GenDSTConfig(psi=2, phi=4), sub_automl=sub, ft_automl=ft,
                         automl_backend="loop")
    q = plan_from_config(cfg)
    assert q.sub_automl.backend == q.ft_automl.backend == "loop"

    X, y = _make(1, 200, 6, 2)
    res = execute(dataclasses.replace(p, backend="spy"), X, y, seed=0, device="cpu")
    # two sub-AutoML rungs on the subset, then one fine-tune rung on all rows
    assert len(spy_backend) == 3
    assert spy_backend[0] == spy_backend[1] and spy_backend[1][0] < spy_backend[2][0]
    assert res.intermediate.backend == res.final.backend == "spy"
    spy_backend.clear()
    res = substrat(X, y, seed=0, config=dataclasses.replace(cfg, automl_backend="spy"),
                   device="cpu")
    assert len(spy_backend) == 3 and res.final.backend == "spy"
