"""The scheduler's own spans (``service/scheduler.py``): inside an
``obs.trace.collect`` one ``sched.dst`` span a subset-search dispatch and one
``sched.rungs`` span a rung dispatch, whose counts match the scheduler's
``stats()`` and metric counters step by step; outside a collect they record
nothing.  The port alone, on the CPU; no JAX.

Tolerances: none (counts are equal; FLOPs are the counters' own floats).
"""
import dataclasses
import time

import pytest

from repro_torch.automl.engine import AutoMLConfig
from repro_torch.core.gen_dst import GenDSTConfig
from repro_torch.core.plan import plan
from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
from repro_torch.obs import trace
from repro_torch.service import SubStratServer

COUNTERS = ("merged_rungs", "merged_jobs", "solo_rungs", "merged_dst")


def _table(name, seed, scale):
    spec = dataclasses.replace(PAPER_DATASETS[name], seed=seed)
    return train_test_split(*make_dataset(spec, scale=scale))


@pytest.fixture(scope="module")
def fleet():
    """Three tables of one shape, the first again (a duplicate search), and
    one of another shape: a batched search of three, a coalesced duplicate,
    a solo search; rungs of two shapes."""
    A = _table("D3", 3, 0.05)
    return [A, _table("D3", 11, 0.05), _table("D3", 12, 0.05), A, _table("D7", 7, 0.01)]


def _plan(**kw):
    return plan("gen_dst", cfg=GenDSTConfig(psi=2, phi=4),
                sub_automl=AutoMLConfig(n_trials=4, rungs=(3, 6)),
                ft_automl=AutoMLConfig(n_trials=4, rungs=(6,)), **kw)


def _server(fleet, **kw):
    srv = SubStratServer(batch_dst=True, warm_start=False, device="cpu", **kw)
    ids = [srv.submit(X, y, plan=_plan(), seed=7 + i, X_test=Xt, y_test=yt)
           for i, (X, y, Xt, yt) in enumerate(fleet)]
    return srv, ids


def _counts(sched):
    st = sched.stats()
    return ({k: st[k] for k in COUNTERS}, sched.m_padded_flops.value(),
            sched.m_useful_flops.value())


@pytest.mark.parametrize("server", [dict(), dict(hetero_merge=False),
                                    dict(megabatch=False)],
                         ids=["megabatch", "same-shape", "lockstep"])
def test_one_span_per_dispatch_with_the_stats_counts(fleet, server):
    srv, ids = _server(fleet, **server)
    sched = srv.scheduler
    searches = batched = 0
    while sched.pending():
        phases = [j.phase for j in sched.pending()]
        (c0, pad0, use0) = _counts(sched)
        sink = []
        with trace.collect(sink):
            sched.step()
        (c1, pad1, use1) = _counts(sched)
        d = {k: c1[k] - c0[k] for k in COUNTERS}
        dst = [s for s in sink if s["name"] == "sched.dst"]
        rungs = [s for s in sink if s["name"] == "sched.rungs"]
        # a step dispatches searches when a job enters it at dst (after its
        # factorize), and rungs while any job is searching a pipeline
        assert len(dst) == int(any(p in ("factorize", "dst") for p in phases))
        assert len(rungs) <= 1
        for sp in dst:
            assert sp["attrs"]["batched"] == d["merged_dst"]
            searches += sp["attrs"]["searches"]
            batched += sp["attrs"]["batched"]
            assert sp["t1"] >= sp["t0"] and sp["parent_id"] is None
        if rungs:
            a = rungs[0]["attrs"]
            assert a["dispatches"] == d["merged_rungs"] + d["solo_rungs"] >= 1
            assert a["jobs"] == d["merged_jobs"] + d["solo_rungs"]
            assert a["padded_flops"] == pad1 - pad0 and a["useful_flops"] == use1 - use0
        else:
            assert d["merged_rungs"] == d["solo_rungs"] == 0
        # the spans the searches open land under the dispatch's span
        gens = [s for s in sink if s["name"] == "gen_dst.generation"]
        assert all(g["parent_id"] in {s["span_id"] for s in dst} for g in gens)
    assert all(srv.poll(j).done for j in ids)
    # three same-shaped searches batched, the duplicate served by the cache,
    # the other shape alone
    assert (searches, batched) == (4, 3) == (4, sched.stats()["merged_dst"])
    assert sum(srv.poll(j).cache_hit for j in ids) == 1


def test_outside_a_collect_nothing_is_recorded(fleet):
    closed = []
    with trace.collect(closed):
        pass
    srv, ids = _server(fleet)
    srv.run()
    assert closed == [] and trace.current_span() is None
    for j in ids:
        names = {s["name"] for s in srv.scheduler.jobs[j].spans}
        assert not any(n.startswith("sched.") for n in names)
    # the spans change no result: the same fleet served inside a collect
    again, again_ids = _server(fleet)
    with trace.collect([]):
        again.run()
    for a, b in zip(ids, again_ids):
        ra, rb = srv.result(a), again.result(b)
        assert (ra.row_idx == rb.row_idx).all() and ra.dst_fitness == rb.dst_fitness
        assert ra.final.spec == rb.final.spec and ra.final.test_acc == rb.final.test_acc


def test_the_factorize_span_covers_the_codes_and_the_fingerprint(fleet, monkeypatch):
    """A served job's ``factorize`` span holds ``factorize``'s own spans and
    the host reads of its codes: the fingerprint and the meta-features."""
    import repro_torch.service.scheduler as sched_mod
    calls = []

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.time()
            out = fn(*args, **kwargs)
            calls.append((name, t0, time.time()))
            return out
        return wrapped

    for name in ("dataset_fingerprint", "meta_features"):
        monkeypatch.setattr(sched_mod, name, timed(name, getattr(sched_mod, name)))
    X, y, Xt, yt = fleet[0]
    srv = SubStratServer(batch_dst=True, warm_start=True, device="cpu")
    jid = srv.submit(X, y, plan=_plan(), seed=7, X_test=Xt, y_test=yt)
    sink = []
    with trace.collect(sink):
        srv.run()
    (fz,) = [s for s in srv.scheduler.jobs[jid].spans if s["name"] == "factorize"]
    inner = [s for s in sink if s["name"].startswith("factorize.")]
    assert [s["name"] for s in inner] == ["factorize.host", "factorize.copy", "factorize.device"]
    assert sorted(n for n, _, _ in calls) == ["dataset_fingerprint", "meta_features"]
    assert fz["t0"] <= inner[0]["t0"]
    for _, t0, t1 in calls:
        assert inner[-1]["t1"] <= t0 <= t1 <= fz["t1"]
    assert fz["attrs"]["seconds"] >= sum(t1 - t0 for _, t0, t1 in calls)
