"""The port's ``service/`` (fingerprint, DST cache, scheduler, server) held to
the JAX package's on the CPU, and to the port's own ``execute``.

Tolerances: fingerprints, cache orders, packing groups, phase sequences,
cache hits, merge counts, metric counters and winner specs are equal.  A
served fleet's validation accuracies agree within 2/N_val and test
accuracies within 2/N_test (the trials train in float32 in both packages,
in another summation order).  The fleet's subset strategy is one
deterministic numpy function registered under the same name in both
packages, so both serve the same subsets; its AutoML seed samples no MLP,
whose init the port draws with torch.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest

from repro.automl.engine import AutoMLConfig as JCfg
from repro.core.measures import factorize as j_factorize
from repro.core.plan import plan as j_plan
from repro.service import DSTCache as JCache, DSTCacheEntry as JEntry
from repro.service import SubStratServer as JServer, dataset_fingerprint as j_fingerprint
from repro.service.scheduler import (
    CohortMeta as JMeta, Scheduler as JScheduler, merge_waste as j_waste,
    pack_megabatches as j_pack,
)
from repro_torch.automl.engine import FAMILIES, AutoMLConfig as TCfg, search_init
from repro_torch.core.gen_dst import GenDSTConfig
from repro_torch.core.measures import factorize as t_factorize
from repro_torch.core.plan import execute, plan as t_plan
from repro_torch.core.strategies import run_strategy_batch
from repro_torch.core.substrat import SubStratConfig
from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
from repro_torch.device import make_generator
from repro_torch.service import (
    BudgetExceeded, DSTCache as TCache, DSTCacheEntry as TEntry, RateLimited,
    SubStratServer as TServer, TokenBucket, dataset_fingerprint as t_fingerprint,
)
from repro_torch.service.cache import dst_cache_key
from repro_torch.service.scheduler import (
    CohortMeta as TMeta, Scheduler as TScheduler, merge_waste as t_waste,
    pack_megabatches as t_pack,
)

from _torch_port import np_strategy_registered, t_np

STRATEGY = "test_torch_service_np"


@pytest.fixture(scope="module", autouse=True)
def registered():
    """The strategy, registered in both packages for this module's tests only
    (the registries are process-global; other test files count them)."""
    with np_strategy_registered(STRATEGY):
        yield

# this AutoML seed samples no MLP at 6 trials on the fleet's subsets (asserted below)
SUB = dict(n_trials=6, rungs=(5, 10), seed=6)
FT = dict(n_trials=4, rungs=(10,), seed=6)


def _table(name, seed, scale):
    spec = dataclasses.replace(PAPER_DATASETS[name], seed=seed)
    return train_test_split(*make_dataset(spec, scale=scale))


@pytest.fixture(scope="module")
def tables():
    """The phase-12 fleet at a small size: a table A, two more of its spec
    with other seeds, A again, a table of another shape; then a fifth of
    A's spec for the warm start."""
    A = _table("D3", 3, 0.1)
    return [A, _table("D3", 11, 0.1), _table("D3", 12, 0.1), A, _table("D7", 7, 0.02),
            _table("D3", 13, 0.1)]


# ---------------------------------------------------------------------------
# fingerprint, cache, packing policy
# ---------------------------------------------------------------------------


def test_fingerprint_is_the_reference_hex_string(tables):
    for X, y, _xt, _yt in tables[:3] + tables[4:5]:
        got = t_fingerprint(t_factorize(X, y, device="cpu"))
        assert got == j_fingerprint(j_factorize(X, y))
        assert len(got) == 64
    X, y = tables[0][:2]
    X2 = X.copy()
    X2[0, 0] += 100.0
    fp = t_fingerprint(t_factorize(X, y, device="cpu"))
    assert t_fingerprint(t_factorize(X2, y, device="cpu")) != fp
    assert t_fingerprint(t_factorize(X, 1 - y, device="cpu")) != fp
    assert t_fingerprint(t_factorize(X, y, device="cpu")) == fp


def _cache_ops(seed):
    """A random sequence of cache operations: puts of entries of various
    sizes and costs, gets (hits and misses), peeks and winner notes."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(60):
        k = f"fp{int(rng.integers(0, 12))}"
        r = rng.random()
        if r < 0.45:
            ops.append(("put", k, int(rng.integers(1, 40)), float(rng.uniform(0.001, 5.0))))
        elif r < 0.8:
            ops.append(("get", k))
        elif r < 0.9:
            ops.append(("peek", k))
        else:
            ops.append(("winner", k))
    return ops


def _drive_cache(cache, Entry, ops):
    trace = []
    for op in ops:
        key = dst_cache_key(op[1], 4, 2, "entropy")
        if op[0] == "put":
            cache.put(key, Entry(row_idx=np.arange(op[2]), col_mask=np.ones(3, bool),
                                 fitness=-1.0, cost_s=op[3]))
        elif op[0] == "get":
            trace.append(cache.get(key) is not None)
        elif op[0] == "peek":
            trace.append(cache.peek(key) is not None)
        else:
            cache.note_winner(key, "gnb")
        trace.append([k[0] for k, _e in cache.items()])
    return trace, cache.stats()


@pytest.mark.parametrize("policy,capacity,budget", [
    ("lru", 4, None), ("gdsf", 4, None), ("lru", 16, 300), ("gdsf", 16, 300), ("gdsf", 3, 100)])
@pytest.mark.parametrize("seed", range(3))
def test_cache_evicts_as_the_reference(policy, capacity, budget, seed):
    ops = _cache_ops(seed)
    got = _drive_cache(TCache(capacity, byte_budget=budget, policy=policy), TEntry, ops)
    want = _drive_cache(JCache(capacity, byte_budget=budget, policy=policy), JEntry, ops)
    assert got == want
    assert got[1]["evictions"] > 0
    e = TEntry(row_idx=np.arange(5, dtype=np.int32), col_mask=np.ones(7, bool), fitness=0.0)
    assert e.nbytes == 5 * 4 + 7


def _random_metas(rng):
    """The reference's property-test metas (tests/test_continuous_batching.py)."""
    metas = []
    for _ in range(int(rng.integers(1, 11))):
        shape = (int(rng.integers(20, 3000)), int(rng.integers(8, 1000)),
                 int(rng.integers(2, 30)), int(rng.integers(2, 13)))
        steps = tuple(int(rng.integers(1, 61)) for _ in range(int(rng.integers(1, 9))))
        metas.append((shape, steps))
    return metas


@pytest.mark.parametrize("seed", range(8))
def test_packing_policy_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    raw = _random_metas(rng)
    tm = [TMeta(s, st) for s, st in raw]
    jm = [JMeta(s, st) for s, st in raw]
    assert t_waste(tm) == j_waste(jm)
    for budget in (1.0, 1.5, 2.0, 4.0, float(rng.uniform(1.2, 10.0))):
        for same in (False, True):
            groups = t_pack(tm, budget, same_shape_only=same)
            assert groups == j_pack(jm, budget, same_shape_only=same)
            assert sorted(i for g in groups for i in g) == list(range(len(tm)))
            for g in groups:
                assert t_waste([tm[i] for i in g]) == j_waste([jm[i] for i in g])


# ---------------------------------------------------------------------------
# a served fleet: the port's server against the reference's
# ---------------------------------------------------------------------------


def _serve(Server, Scheduler, pl, cfg, tables, **sched_kw):
    srv = Server(scheduler=Scheduler(batch_dst=True, portfolio_k=3, **sched_kw))
    ids = [srv.submit(X, y, plan=pl, X_test=Xt, y_test=yt, tenant=f"t{i % 4}",
                      **cfg(i))
           for i, (X, y, Xt, yt) in enumerate(tables[:5])]
    srv.run()
    first = srv.stats()
    X, y, Xt, yt = tables[5]
    ids.append(srv.submit(X, y, plan=pl, X_test=Xt, y_test=yt, tenant="t1", **cfg(5)))
    srv.run()
    return srv, ids, first


@pytest.fixture(scope="module")
def fleets(tables):
    assert "mlp" in FAMILIES
    for X, y, _xt, _yt in tables:      # the sub-AutoML's input: sqrt(N) subset rows
        n = int(np.sqrt(len(y)))
        st = search_init(X[:n], y[:n], config=TCfg(**SUB), device="cpu")
        assert all(s.family != "mlp" for s in st.specs)
    ref = _serve(JServer, JScheduler,
                 j_plan(STRATEGY, sub_automl=JCfg(**SUB), ft_automl=JCfg(**FT)),
                 lambda i: {"key": jax.random.key(i)}, tables)
    port = _serve(TServer, TScheduler,
                  t_plan(STRATEGY, sub_automl=TCfg(**SUB), ft_automl=TCfg(**FT)),
                  lambda i: {"seed": i}, tables, device="cpu")
    return ref, port


_COUNTERS = ("merged_rungs", "merged_jobs", "hetero_rungs", "mixed_rungs", "solo_rungs",
             "merged_dst", "poisoned_packs")
# metric families whose values are counts, not seconds
_COUNT_FAMILIES = ("cache_hits_total", "cache_misses_total", "dispatches_total",
                   "jobs_finished_total", "portfolio_hits_total",
                   "portfolio_seeded_trials_total", "portfolio_trials_saved_total",
                   "experience_datasets")


def test_fleet_phases_cache_and_merges_match_the_reference(fleets):
    (jsrv, jids, jfirst), (tsrv, tids, tfirst) = fleets
    assert tids == jids
    for first in (jfirst, tfirst):
        assert first["merged_dst"] == 3 and first["cache"]["hits"] >= 1
    for key in _COUNTERS:
        assert tfirst[key] == jfirst[key], key
        assert tsrv.stats()[key] == jsrv.stats()[key], key
    assert tfirst["merged_rungs"] >= 1 and tfirst["hetero_rungs"] >= 1
    for key in ("hits", "misses", "size", "evictions"):
        assert tsrv.stats()["cache"][key] == jsrv.stats()["cache"][key]
    for jid in tids:
        tj, jj = tsrv.scheduler.jobs[jid], jsrv.scheduler.jobs[jid]
        assert tj.phase == jj.phase == "done"
        assert [s["name"] for s in tj.spans] == [s["name"] for s in jj.spans]
        assert tj.fingerprint == jj.fingerprint
        ts, js = tsrv.poll(jid), jsrv.poll(jid)
        assert (ts.cache_hit, ts.warm_started) == (js.cache_hit, js.warm_started)
        assert set(ts.times) == set(js.times)
        assert [(e["phase"], e["rung"], e["alive"], e["trials_done"]) for e in ts.leaderboard] \
            == [(e["phase"], e["rung"], e["alive"], e["trials_done"]) for e in js.leaderboard]
        assert tj.coded is None and tj.search is None and tj.X is None   # released
    assert tsrv.poll(tids[3]).cache_hit and tsrv.poll(tids[3]).warm_started
    tm, jm = tsrv.scheduler.metrics.to_dict(), jsrv.scheduler.metrics.to_dict()
    assert set(tm) == set(jm)
    for name in _COUNT_FAMILIES:
        assert tm[name] == jm[name], name
    assert tm["portfolio_hits_total"]["value"] == 1
    assert tm["portfolio_trials_saved_total"]["value"] > 0
    assert tm["portfolio_coverage"] == jm["portfolio_coverage"]


def test_fleet_winners_match_the_reference(fleets, tables):
    (jsrv, jids, _), (tsrv, tids, _) = fleets
    for jid, (_x, _y, _xt, yt) in zip(tids, tables):
        tr, jr = tsrv.result(jid), jsrv.result(jid)
        np.testing.assert_array_equal(tr.row_idx, jr.row_idx)
        np.testing.assert_array_equal(tr.col_idx, jr.col_idx)
        assert tr.dst_fitness == jr.dst_fitness
        for tp, jp in ((tr.intermediate, jr.intermediate), (tr.final, jr.final)):
            assert tp.spec.family == jp.spec.family and tp.spec.hp == jp.spec.hp
            assert (tp.spec.preproc, tp.spec.feature_frac) == (jp.spec.preproc,
                                                              jp.spec.feature_frac)
            assert tp.n_trials == jp.n_trials
        sub_val = max(1, int(0.2 * len(tr.row_idx)))
        assert abs(tr.intermediate.val_acc - jr.intermediate.val_acc) <= 2.0 / sub_val + 1e-9
        assert abs(tr.final.test_acc - jr.final.test_acc) <= 2.0 / len(yt) + 1e-9


# ---------------------------------------------------------------------------
# the port's served Gen-DST jobs against its own execute and gen_dst_batch
# ---------------------------------------------------------------------------


def test_served_gen_dst_equals_execute_and_the_batch(tables):
    cfg = GenDSTConfig(psi=2, phi=4)
    pl = t_plan("gen_dst", cfg=cfg, sub_automl=TCfg(n_trials=4, rungs=(3, 6)),
                ft_automl=TCfg(n_trials=4, rungs=(6,)))
    data = tables[:3]
    srv = TServer(batch_dst=True, warm_start=False, device="cpu")
    ids = [srv.submit(X, y, plan=pl, seed=7 + i, X_test=Xt, y_test=yt)
           for i, (X, y, Xt, yt) in enumerate(data)]
    srv.run()
    assert srv.stats()["merged_dst"] == 3 and srv.stats()["merged_rungs"] >= 1
    batch = run_strategy_batch("gen_dst", [make_generator(7 + i) for i in range(3)],
                               [t_factorize(X, y, device="cpu") for X, y, _a, _b in data],
                               None, None, pl.strategy_opts)
    for i, (jid, (X, y, Xt, yt)) in enumerate(zip(ids, data)):
        got = srv.result(jid)
        solo = execute(pl, X, y, seed=7 + i, X_test=Xt, y_test=yt, device="cpu")
        for other in (solo, batch[i]):
            np.testing.assert_array_equal(got.row_idx, other.row_idx)
        np.testing.assert_array_equal(got.col_idx, solo.col_idx)
        assert got.dst_fitness == solo.dst_fitness == batch[i].fitness
        assert got.intermediate.spec == solo.intermediate.spec
        assert got.final.spec.family == solo.final.spec.family
        n_val = max(1, int(0.2 * len(got.row_idx)))
        assert abs(got.intermediate.val_acc - solo.intermediate.val_acc) <= 2.0 / n_val
        assert abs(got.final.test_acc - solo.final.test_acc) <= 2.0 / len(yt)


# ---------------------------------------------------------------------------
# tenancy, rate limits, failure isolation, opt-outs
# ---------------------------------------------------------------------------

def _small():
    return t_plan(STRATEGY, sub_automl=TCfg(**SUB), ft_automl=TCfg(**FT))


def test_tenant_budget_enforced(tables):
    (XA, yA, _a, _b), (XB, yB, _c, _d) = tables[0], tables[4]
    srv = TServer(tenant_budgets={"alice": 1e-6}, device="cpu")
    jid = srv.submit(XA, yA, tenant="alice", plan=_small())     # admitted: no spend yet
    srv.run()
    assert srv.poll(jid).done
    with pytest.raises(BudgetExceeded):
        srv.submit(XA, yA, tenant="alice", plan=_small())
    assert srv.result(srv.submit(XB, yB, tenant="bob", plan=_small())).final is not None
    assert srv.stats()["tenants"]["alice"]["spent_s"] > 1e-6


def test_token_bucket_and_server_rate_limit(tables):
    t = [0.0]
    bucket = TokenBucket(rate=2.0, burst=3.0, clock=lambda: t[0])
    assert [bucket.try_acquire() for _ in range(3)] == [0.0, 0.0, 0.0]
    assert bucket.try_acquire() == pytest.approx(0.5)
    t[0] += 0.5
    assert bucket.try_acquire() == 0.0
    t[0] += 100.0
    assert bucket.tokens == pytest.approx(3.0)
    with pytest.raises(ValueError):
        TokenBucket(rate=0.0, burst=1.0)
    X, y = tables[0][:2]
    srv = TServer(tenant_rate_limits={"a": (1.0, 2.0)}, rate_clock=lambda: t[0], device="cpu")
    srv.submit(X, y, tenant="a", plan=_small())
    srv.submit(X, y, tenant="a", plan=_small())
    with pytest.raises(RateLimited) as exc:
        srv.submit(X, y, tenant="a", plan=_small())
    assert exc.value.retry_after_s == pytest.approx(1.0)
    srv.submit(X, y, tenant="b", plan=_small())
    t[0] += 1.0
    srv.submit(X, y, tenant="a", plan=_small())
    text = srv.metrics_text()
    assert 'rate_limited_total{tenant="a"} 1' in text
    assert "# TYPE torch_kernel_builds_total counter" in text
    assert srv.stats()["rate_limits"]["a"]["burst"] == 2.0


def test_failed_job_is_isolated_and_dst_fn_bypasses_the_cache(tables):
    (XA, yA, _a, _b), (XB, yB, _c, _d) = tables[0], tables[4]
    config = SubStratConfig(gen=GenDSTConfig(psi=2, phi=4), sub_automl=TCfg(**SUB),
                            ft_automl=TCfg(**FT))

    def bad_dst(generator, coded, n, m):
        raise RuntimeError("boom")

    srv = TServer(device="cpu")
    with pytest.warns(DeprecationWarning, match="dst_fn"):
        bad = srv.submit(XA, yA, config=config, dst_fn=bad_dst)
    good = srv.submit(XB, yB, config=config)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        a = srv.submit(XA, yA, config=config, dst_fn=t_np)
        b = srv.submit(XA, yA, config=config, dst_fn=t_np)
    srv.run()
    assert srv.poll(bad).phase == "failed" and "boom" in srv.poll(bad).error
    assert srv.poll(good).done and srv.poll(a).done and srv.poll(b).done
    assert not srv.poll(a).cache_hit and not srv.poll(b).cache_hit
    assert srv.stats()["cache"]["size"] == 1          # only the Gen-DST job's subset
    assert srv.stats()["metrics"]["jobs_finished_total"]["values"] == {"done": 3, "failed": 1}
    with pytest.raises(RuntimeError):
        srv.result(bad)
    with pytest.raises(ValueError, match="not both"):
        srv.submit(XA, yA, plan=_small(), config=config)


def test_poisoned_pack_fails_only_its_culprit(tables, monkeypatch):
    """A megabatch that raises is re-run member by member: only the job that
    fails alone is failed."""
    from repro_torch.automl import batched
    real = batched.eval_trial_megabatch

    def flaky(cohorts, collect_params=None):
        if any(tc.shape[2] == tables[4][0].shape[1] for tc in cohorts):
            raise RuntimeError("poisoned")
        return real(cohorts, collect_params)
    monkeypatch.setattr(batched, "eval_trial_megabatch", flaky)
    srv = TServer(device="cpu")
    ids = [srv.submit(X, y, plan=_small()) for X, y, _a, _b in (tables[0], tables[4])]
    srv.run()
    assert srv.poll(ids[0]).done and srv.poll(ids[1]).phase == "failed"
    assert srv.stats()["poisoned_packs"] >= 1


def test_continuous_batching_and_warm_start_opt_outs(tables):
    """``Plan(continuous_batching=False)`` takes the lockstep buckets (no
    megabatch dispatch); ``Plan(warm_start=False)`` takes no portfolio even
    with enough history, and matches the cold run."""
    from repro_torch.automl import batched
    lock = dataclasses.replace(_small(), continuous_batching=False, warm_start=False)
    seen = []
    real = batched.eval_trial_megabatch
    batched.eval_trial_megabatch = lambda *a, **k: seen.append(1) or real(*a, **k)
    try:
        srv = TServer(device="cpu")
        ids = [srv.submit(X, y, plan=lock, seed=i) for i, (X, y, _a, _b) in enumerate(tables[:3])]
        srv.run()
    finally:
        batched.eval_trial_megabatch = real
    assert not seen and srv.stats()["merged_rungs"] >= 1
    assert all(srv.poll(j).done for j in ids)
    sched = srv.scheduler
    sched.warm_min_history = 1
    X, y = tables[5][:2]
    cold = execute(lock, X, y, seed=5, device="cpu")
    out = srv.result(srv.submit(X, y, plan=lock, seed=5))
    assert sched.m_portfolio_hits.value() == 0
    assert out.intermediate.spec == cold.intermediate.spec
    assert out.intermediate.n_trials == cold.intermediate.n_trials
    X, y = tables[4][:2]                  # a table no job has served yet
    warm = srv.result(srv.submit(X, y, plan=_small(), seed=5))
    assert sched.m_portfolio_hits.value() == 1 and warm.final is not None

