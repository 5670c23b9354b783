"""The port's ``meta/`` (meta-features, the experience store, the portfolio
builder) and ``search_init(seed_trials=)`` held to the JAX package's.

Tolerances: the meta-feature vectors within 1e-6 relative of the
reference's, and within 1e-6 absolute of a float64 numpy recomputation.  The
per-column entropies are float32 in both packages, but the reference sums
them in float32 (2e-6 off at 7.23 bits: 150 equal bins, where the port, summing
in float64 and rounding once, gives log2(150)); every other slot is the same
numpy arithmetic.  Everything else is equal: portfolio picks, k-NN slices,
coverage values, seeded specs and alive ids.
"""
import numpy as np
import pytest

from repro.automl.engine import (
    AutoMLConfig as JCfg, PipelineSpec as JSpec, search_init as j_search_init,
)
from repro.core.measures import factorize as j_factorize
from repro.meta import (
    ExperienceStore as JStore, greedy_portfolio as j_greedy, knn_fingerprints as j_knn,
    meta_features as j_meta, portfolio_coverage as j_coverage, portfolio_for as j_portfolio_for,
)
from repro_torch.automl.engine import (
    AutoMLConfig as TCfg, PipelineSpec as TSpec, search_eval_rung, search_init as t_search_init,
)
from repro_torch.core.measures import factorize as t_factorize
from repro_torch.data.tabular import PAPER_DATASETS, make_dataset
from repro_torch.meta import (
    META_FEATURE_NAMES, ExperienceStore as TStore, greedy_portfolio as t_greedy,
    knn_fingerprints as t_knn, meta_features as t_meta, portfolio_coverage as t_coverage,
    portfolio_for as t_portfolio_for, spec_sort_key,
)

META_TOL = 1e-6


def _meta_float64(X, y):
    """The meta-feature vector computed in float64 with numpy alone."""
    from repro_torch.core.measures import host_codes
    coded = t_factorize(X, y, device="cpu")
    codes, n_bins = host_codes(coded)
    t = coded.target_col

    def entropy(col):
        p = np.bincount(col).astype(np.float64)
        p = p[p > 0] / len(col)
        return float(-(p * np.log2(p)).sum())
    h = np.array([entropy(codes[:, j]) for j in range(codes.shape[1]) if j != t])
    p = np.bincount(codes[:, t]) / len(codes)
    return np.array([np.log1p(len(codes)), np.log1p(codes.shape[1] - 1), n_bins[t], p.max(),
                     entropy(codes[:, t]), h.mean(), h.std(),
                     np.log2(np.delete(n_bins, t).mean())])


def _fields(spec):
    return (spec.preproc, spec.feature_frac, spec.family, spec.hp)


def _make_data(seed: int, N: int = 150, d: int = 6):
    """The reference's meta-test table (tests/test_meta.py)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, N)
    X = np.column_stack([y * 1.5 + rng.normal(0, 0.8, N) for _ in range(d)])
    return X, y


def _tables():
    out = [_make_data(s) for s in (0, 7)]
    for name in ("D3", "D7"):          # dense columns: 256 bins, entropies near 8 bits
        out.append(make_dataset(PAPER_DATASETS[name], scale=0.05))
    rng = np.random.default_rng(3)     # a skewed multi-class target
    out.append((rng.normal(size=(300, 4)), rng.choice(4, 300, p=[0.7, 0.2, 0.05, 0.05])))
    return out


@pytest.mark.parametrize("i", range(5))
def test_meta_features_match_the_reference(i):
    X, y = _tables()[i]
    got = t_meta(t_factorize(X, y, device="cpu"))
    want = j_meta(j_factorize(X, y))
    assert got.shape == (len(META_FEATURE_NAMES),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=META_TOL, atol=0)
    np.testing.assert_allclose(got, _meta_float64(X, y), rtol=0, atol=META_TOL)
    assert t_meta(t_factorize(X, y, device="cpu")).tobytes() == got.tobytes()


def _fill_stores(seed: int, n_fp: int = 6, n_specs: int = 9):
    """The same history in both packages' stores: meta-features, per-rung
    accuracies (ties included), winners for all but one fingerprint."""
    rng = np.random.default_rng(seed)
    stores = (JStore(), TStore())
    families = ("logreg", "gnb", "centroid", "linear_svm")
    specs = [dict(preproc=("none", "minmax", "standardize")[i % 3],
                  feature_frac=(1.0, 0.5)[i % 2], family=families[i % 4],
                  hp=(("lr", 0.01 * (i + 1)),)) for i in range(n_specs)]
    for j in range(n_fp):
        fp = f"{seed:02d}fp{j}"
        feats = rng.normal(size=8).astype(np.float32)
        trials = []
        for i in rng.permutation(n_specs)[:int(rng.integers(3, n_specs + 1))]:
            for rung in range(int(rng.integers(1, 4))):
                acc = float(np.round(rng.uniform(0.3, 1.0), 2))   # coarse: ties happen
                trials.append((int(i), rung, acc))
        for store, Spec in zip(stores, (JSpec, TSpec)):
            store.note_meta(fp, feats)
            for i, rung, acc in trials:
                store.note_trial(fp, Spec(**specs[i]), rung, acc)
            if j != n_fp - 1:
                store.note_winner(fp, Spec(**specs[trials[0][0]]))
    return stores, rng


@pytest.mark.parametrize("seed", range(4))
def test_portfolio_picks_match_the_reference(seed):
    (js, ts), rng = _fill_stores(seed)
    assert ts.trained() == js.trained()
    jm, tm = js.matrix(), ts.matrix()
    assert {_fields(s): v for s, v in tm.items()} == {_fields(s): v for s, v in jm.items()}
    for k in (0, 1, 3, 20):
        picks = t_greedy(tm, k)
        assert [_fields(s) for s in picks] == [_fields(s) for s in j_greedy(jm, k)]
        assert t_coverage(tm, picks) == j_coverage(jm, j_greedy(jm, k))
    assert sorted(tm, key=spec_sort_key) == sorted(tm, key=lambda s: (s.family, s.preproc,
                                                                      s.feature_frac,
                                                                      repr(s.hp)))
    feats = {fp: js.records[fp].features for fp in js.trained()}
    query = rng.normal(size=8).astype(np.float32)
    for k in (0, 2, 10):
        assert t_knn(feats, query, k) == j_knn(feats, query, k)
    exclude = [js.trained()[0]]
    for knn in (0, 2, 10):
        for q in (query, None):
            got = t_portfolio_for(ts, q, k=4, knn=knn, exclude=exclude)
            want = j_portfolio_for(js, q, k=4, knn=knn, exclude=exclude)
            assert [_fields(s) for s in got] == [_fields(s) for s in want]
    assert t_portfolio_for(TStore(), query, k=4, knn=2) == []


def test_store_state_round_trip_is_bit_identical():
    (_js, ts), _rng = _fill_stores(9)
    other = TStore()
    other.load_state(ts.state_dict())
    assert other.trained() == ts.trained() and other.matrix() == ts.matrix()
    for fp, rec in ts.records.items():
        got = other.records[fp]
        assert got.features.tobytes() == rec.features.tobytes()
        assert got.rung_accs == rec.rung_accs and got.winner == rec.winner
        assert got.jobs == rec.jobs
    ts.note_trial(ts.trained()[0], next(iter(ts.matrix())), 0, -1.0)   # worse: ignored
    assert other.matrix() == ts.matrix()


_CFG = dict(n_trials=6, rungs=(4, 8))


def test_search_init_seed_trials_match_the_reference():
    X, y = _make_data(11)
    cold_j = j_search_init(X, y, config=JCfg(**_CFG))
    cold_t = t_search_init(X, y, config=TCfg(**_CFG), device="cpu")
    assert [_fields(s) for s in cold_t.specs] == [_fields(s) for s in cold_j.specs]
    assert cold_t.alive_ids == cold_j.alive_ids
    for empty in (None, []):
        st = t_search_init(X, y, config=TCfg(**_CFG), seed_trials=empty, device="cpu")
        assert st.specs == cold_t.specs and st.alive_ids == cold_t.alive_ids
        assert st.trial_rung == cold_t.trial_rung
    novel = dict(preproc="minmax", feature_frac=0.5, family=cold_j.specs[0].family,
                 hp=cold_j.specs[0].hp)
    assert JSpec(**novel) not in cold_j.specs
    picks = [4, 1, None, 4]                       # a repeat and a novel spec
    seeds_j = [cold_j.specs[i] if i is not None else JSpec(**novel) for i in picks]
    seeds_t = [cold_t.specs[i] if i is not None else TSpec(**novel) for i in picks]
    warm_j = j_search_init(X, y, config=JCfg(**_CFG), seed_trials=seeds_j)
    warm_t = t_search_init(X, y, config=TCfg(**_CFG), seed_trials=seeds_t, device="cpu")
    assert [_fields(s) for s in warm_t.specs] == [_fields(s) for s in warm_j.specs]
    assert warm_t.alive_ids == warm_j.alive_ids == [1, 4, len(cold_j.specs)]
    assert warm_t.trial_rung == warm_j.trial_rung


def test_seeded_trials_score_as_in_the_cold_run():
    """A seeded trial keeps its ``(seed, trial_id, rung)`` generator: its
    rung-0 accuracy equals the cold run's for the same trial (loop backend,
    one trial at a time, so nothing but the generator could differ)."""
    X, y = _make_data(11)
    cfg = TCfg(**_CFG, backend="loop")
    cold = t_search_init(X, y, config=cfg, device="cpu")
    search_eval_rung(cold)
    cold_accs = {spec: float(v) for spec, v, *_ in cold.live}
    warm = t_search_init(X, y, config=cfg, seed_trials=[cold.specs[4], cold.specs[1]],
                         device="cpu")
    assert warm.alive_ids == [1, 4]
    search_eval_rung(warm)
    assert len(warm.live) == 2
    for spec, v, *_ in warm.live:
        assert float(v) == cold_accs[spec]
