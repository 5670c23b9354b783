"""The port's strategy registry and plan fields against the reference's.

The registry holds the reference's 11 strategies with the same flags;
``Plan.cacheable``, ``Plan.batchable`` and ``Plan.subset_identity`` agree
with the reference's for the same arguments; ``run_strategy_batch`` runs
one search for a strategy with a ``batch_fn`` and one per dataset for the
others; every strategy runs end to end through ``execute`` on the CPU; and
``asp_proxy`` picks the reference's rows given the reference's seed.

Tolerances: rows and masks bit-equal; fitness within 1e-6 (the port sums
entropies in float64).
"""
import jax
import numpy as np
import pytest

import repro.core.strategies as JS
import repro_torch.core.strategies as TS
from repro.core.plan import plan as j_plan
from repro.core.measures import factorize as j_factorize
from repro_torch.automl.engine import AutoMLConfig
from repro_torch.core.gen_dst import GenDSTConfig
from repro_torch.core.measures import factorize as t_factorize
from repro_torch.core.plan import execute as t_execute, plan as t_plan
from repro_torch.device import make_generator
from _torch_port import JaxKey, np_


def _data(seed, N=800):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, N)
    informative = y * 3 + rng.integers(0, 3, N)
    noise = [rng.integers(0, 8, N) for _ in range(4)]
    return np.column_stack([informative] + noise).astype(float), y.astype(float)


@pytest.fixture(scope="module")
def data():
    return _data(3)


def test_registry_matches_reference():
    assert TS.available_strategies() == JS.available_strategies()
    assert len(TS.available_strategies()) == 11
    for name in JS.available_strategies():
        ref, out = JS.get_strategy(name), TS.get_strategy(name)
        assert out.cacheable == ref.cacheable, name
        assert (out.batch_fn is None) == (ref.batch_fn is None), name
        assert out.description == ref.description, name
    with pytest.raises(ValueError, match="already registered"):
        TS.register_strategy("mc", lambda *a: None)


@pytest.mark.parametrize("name,opts", [("gen_dst", {}), ("gen_dst_islands", {}),
                                       ("random", {}), ("mc", {"budget": 40}),
                                       ("asp_proxy", {"hard_frac": 0.25})])
@pytest.mark.parametrize("shape", [(None, None), (30, 4), (5000, 50)])
def test_plan_fields_match_reference(data, name, opts, shape):
    n, m = shape
    ref = j_plan(name, n=n, m=m, **opts)
    out = t_plan(name, n=n, m=m, **opts)
    assert (out.cacheable, out.batchable) == (ref.cacheable, ref.batchable)
    cj, ct = j_factorize(*data), t_factorize(*data, device="cpu")
    assert out.subset_identity(ct) == ref.subset_identity(cj)


def test_plan_fields_of_a_callable():
    def my_dst(generator, coded, n, m):
        raise AssertionError("not run")
    p = t_plan(my_dst)
    assert not p.cacheable and not p.batchable


def test_run_strategy_batch_one_search_equals_solo(data):
    X, y = data
    codeds = [t_factorize(X, y, device="cpu"), t_factorize(*_data(4), device="cpu")]
    assert codeds[0].max_bins == codeds[1].max_bins
    opts = (("cfg", GenDSTConfig(psi=4, phi=8)),)
    batch = TS.run_strategy_batch("gen_dst", [make_generator(0), make_generator(1)],
                                  codeds, 20, 3, opts)
    assert len({r.time_s for r in batch}) == 1           # one share each
    for seed, coded, got in zip((0, 1), codeds, batch):
        solo = TS.run_strategy("gen_dst", make_generator(seed), coded, 20, 3, opts)
        np.testing.assert_array_equal(got.row_idx, solo.row_idx)
        np.testing.assert_array_equal(got.col_mask, solo.col_mask)
        assert got.fitness == solo.fitness and got.strategy == "gen_dst"


def test_run_strategy_batch_falls_back_per_dataset(data):
    X, y = data
    coded = t_factorize(X, y, device="cpu")
    opts = (("budget", 40), ("batch", 20))
    batch = TS.run_strategy_batch("mc", [make_generator(0), make_generator(1)],
                                  [coded, coded], 20, 3, opts)
    for seed, got in zip((0, 1), batch):
        solo = TS.run_strategy("mc", make_generator(seed), coded, 20, 3, opts)
        np.testing.assert_array_equal(got.row_idx, solo.row_idx)
        assert got.fitness == solo.fitness and got.strategy == "mc"


SMALL = dict(sub_automl=AutoMLConfig(n_trials=4, rungs=(5,), seed=6),
             ft_automl=AutoMLConfig(n_trials=2, rungs=(5,), seed=6))
FAST_OPTS = {"gen_dst": {"cfg": GenDSTConfig(psi=3, phi=8)},
             "gen_dst_islands": {"cfg": GenDSTConfig(psi=3, phi=8)},
             "mab": {"rounds": 20}, "greedy_seq": {"pool": 16}, "greedy_mult": {"pool": 16}}


@pytest.mark.parametrize("name", TS.available_strategies())
def test_execute_runs_every_strategy_on_cpu(data, name):
    X, y = data
    res = t_execute(t_plan(name, **SMALL, **FAST_OPTS.get(name, {})), X[:600], y[:600],
                     X_test=X[600:], y_test=y[600:], seed=2, device="cpu")
    assert res.strategy == name and len(res.row_idx) == round(600 ** 0.5)
    assert 1 <= len(res.col_idx) <= 1 + round(0.25 * 6)
    assert (name == "random") == np.isnan(res.dst_fitness)
    assert 0.0 <= res.final.test_acc <= 1.0


def _asp_draws(key):
    """The key the reference draws the fill's seed from (strategies.py:248-249)."""
    return JaxKey(jax.random.fold_in(key, 0xA59))


@pytest.mark.parametrize("hard_frac", [0.5, 0.0])
def test_asp_proxy_matches_reference(data, hard_frac):
    X, y = data
    cj, ct = j_factorize(X, y), t_factorize(X, y, device="cpu")
    key = jax.random.key(5)
    ref = JS.asp_proxy_dst(key, cj, 20, 3, hard_frac=hard_frac)
    out = TS.asp_proxy_dst(None, ct, 20, 3, hard_frac=hard_frac,
                           device="cpu", draws=_asp_draws(key))
    np.testing.assert_array_equal(np_(out.row_idx), np.asarray(ref.row_idx))
    np.testing.assert_array_equal(np_(out.col_mask), np.asarray(ref.col_mask))
    np.testing.assert_allclose(float(out.fitness), float(ref.fitness), atol=1e-6)
    np.testing.assert_allclose(float(out.f_ref), float(ref.f_ref), atol=1e-6)


def test_asp_proxy_fill_matches_reference():
    """A subset of most of a small table: rounding leaves classes short, and
    the random fill draws the reference's rows from the reference's seed."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 30).astype(float)
    X = rng.integers(0, 5, (30, 4)).astype(float)
    cj, ct = j_factorize(X, y), t_factorize(X, y, device="cpu")
    rows = {}
    for seed in (0, 1):
        key = jax.random.key(seed)
        ref = JS.asp_proxy_dst(key, cj, 24, 3, hard_frac=0.0)
        out = TS.asp_proxy_dst(None, ct, 24, 3, hard_frac=0.0,
                               device="cpu", draws=_asp_draws(key))
        np.testing.assert_array_equal(np_(out.row_idx), np.asarray(ref.row_idx))
        np.testing.assert_array_equal(np_(out.col_mask), np.asarray(ref.col_mask))
        rows[seed] = np.asarray(ref.row_idx)
    assert not np.array_equal(rows[0], rows[1]), "the fill drew rows"
    # from a generator: a valid DST
    res = TS.asp_proxy_dst(make_generator(3), ct, 24, 3, hard_frac=0.0, device="cpu")
    assert len(np.unique(np_(res.row_idx))) == 24 and bool(res.col_mask[ct.target_col])
