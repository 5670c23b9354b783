"""The port's cross-process serving tier (``service/transport.py``,
``worker.py``, the scheduler's snapshots) held to its in-process scheduler
and to the JAX package's ``DistributedScheduler`` on the CPU.

The jobs are ``tests/test_transport.py``'s two small tables with its plan's
sizes, served with one deterministic numpy subset strategy registered in
both packages (so both serve the same subsets) and an AutoML seed that
samples no MLP (whose init the port draws with torch), as
``tests/test_torch_service.py`` arranges.

Tolerances: the port's distributed runs equal its in-process run exactly
(winner specs, every trial accuracy, test accuracies, subsets).  Against
the reference under each fault plan: the transport counters, phases, merge
counters, cache stats and winner specs are equal.  The run across real
worker processes holds trial accuracies within 1e-6, as the reference's
holds its own.
"""
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from harness.faultsim import FaultPlan
from repro.automl import batched as j_batched
from repro.automl.engine import AutoMLConfig as JCfg
from repro.core.plan import plan as j_plan
from repro.service import DistributedScheduler as JDist, SimWorkerPool as JSim
from repro.service.cache import DSTCache as JCache
from repro_torch.automl import batched as t_batched
from repro_torch.automl.engine import AutoMLConfig as TCfg
from repro_torch.core.plan import plan as t_plan
from repro_torch.service import (
    DistributedScheduler as TDist, DSTCache as TCache, ProcessWorkerPool,
    Scheduler as TSched, SimWorkerPool as TSim, SubStratHTTPClient, SubStratHTTPServer,
    SubStratServer,
)
from repro_torch.service import transport, wire

from _torch_port import np_strategy_registered

STRATEGY = "test_torch_transport_np"
SIZES = dict(n=24, m=4)
SUB = dict(n_trials=4, rungs=(2, 4), seed=0)      # seed 0 samples no MLP here
FT = dict(n_trials=2, rungs=(2,), seed=0)
_COUNTERS = ("merged_rungs", "merged_jobs", "hetero_rungs", "mixed_rungs", "solo_rungs",
             "merged_dst", "poisoned_packs")


@pytest.fixture(scope="module", autouse=True)
def registered():
    with np_strategy_registered(STRATEGY):
        yield


@pytest.fixture(scope="module")
def plans():
    return (j_plan(STRATEGY, sub_automl=JCfg(**SUB), ft_automl=JCfg(**FT), **SIZES),
            t_plan(STRATEGY, sub_automl=TCfg(**SUB), ft_automl=TCfg(**FT), **SIZES))


def _make(seed, N=48, d=6, c=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, d)).astype(np.float32)
    y = (np.arange(N) % c).astype(np.int64)
    return X, y


def _tables():
    """Two jobs' (X, y, X_test, y_test)."""
    return [(*_make(i), *_make(10 + i)) for i in range(2)]


def _submit_two(sched, pl, ref=False):
    ids = []
    for i, (X, y, Xt, yt) in enumerate(_tables()):
        seed = {"key": jax.random.key(i + 1)} if ref else {"seed": i + 1}
        ids.append(sched.submit(X, y, plan=pl, X_test=Xt, y_test=yt, **seed))
    return ids


def _run_port(pool, pl, **kw):
    sched = TDist(pool, cache=TCache(), device="cpu", **kw)
    ids = _submit_two(sched, pl)
    sched.run()
    return sched, ids


def _run_ref(pool, pl, **kw):
    sched = JDist(pool, cache=JCache(), **kw)
    ids = _submit_two(sched, pl, ref=True)
    sched.run()
    return sched, ids


@pytest.fixture(scope="module")
def baseline(plans):
    """The port's fault-free in-process results for the two jobs."""
    sched = TSched(TCache(), device="cpu")
    ids = _submit_two(sched, plans[1])
    sched.run()
    return [sched.jobs[j].result for j in ids]


def _leaves(params):
    return torch.utils._pytree.tree_leaves(params)


def _assert_equal_results(got, want):
    """Bit-identical: subsets, winner specs, every trial accuracy, test
    accuracies, the winners' params (as tensors)."""
    np.testing.assert_array_equal(got.row_idx, want.row_idx)
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    assert got.dst_fitness == want.dst_fitness
    for g, w in ((got.intermediate, want.intermediate), (got.final, want.final)):
        assert g.spec == w.spec
        assert [v for _, v in g.trials] == [v for _, v in w.trials]
        assert g.val_acc == w.val_acc and g.test_acc == w.test_acc
        assert g.n_trials == w.n_trials
        for a, b in zip(_leaves(g.params), _leaves(w.params)):
            assert isinstance(a, torch.Tensor) and torch.equal(a, b)


def _summary(sched, ids):
    """What must agree between the two packages' schedulers."""
    jobs = []
    for j in ids:
        job = sched.jobs[j]
        res = job.result
        jobs.append({
            "phase": job.phase,
            "failed": job.error is not None,
            "cache_hit": job.cache_hit,
            "leaderboard": [(e["phase"], e["rung"], e["alive"], e["trials_done"])
                            for e in job.leaderboard],
            "winner": None if res is None else tuple(
                (r.spec.preproc, r.spec.feature_frac, r.spec.family, r.spec.hp, r.n_trials)
                for r in (res.intermediate, res.final)),
        })
    stats = sched.stats()
    return {"jobs": jobs, "counters": {k: stats[k] for k in _COUNTERS},
            "cache": {k: stats["cache"][k] for k in ("hits", "misses", "size")},
            "transport": stats["transport"]}


# ---------------------------------------------------------------------------
# fault-free: the distributed scheduler is the in-process one
# ---------------------------------------------------------------------------


def test_sim_pool_equals_in_process(plans, baseline):
    pool = TSim(2)
    sched, ids = _run_port(pool, plans[1])
    assert pool.device == torch.device("cpu")     # the scheduler's device
    for j, want in zip(ids, baseline):
        assert sched.jobs[j].phase == "done"
        _assert_equal_results(sched.jobs[j].result, want)
    t = sched.stats()["transport"]
    assert t["remote_tasks"] > 0 and pool.tasks_evaluated == t["remote_tasks"]
    assert t["worker_failures"] == 0
    names = {s["name"] for s in sched.jobs[ids[0]].spans}
    assert {"dispatch", "queue_wait", "deserialize", "eval", "serialize"} <= names
    dispatch = next(s for s in sched.jobs[ids[0]].spans if s["name"] == "dispatch")
    assert dispatch["attrs"]["bytes"] > 0 and dispatch["attrs"]["reply_bytes"] > 0
    assert dispatch["attrs"]["encode_s"] >= 0 and dispatch["attrs"]["decode_s"] >= 0


# ---------------------------------------------------------------------------
# every fault plan of the reference's tests, against the reference
# ---------------------------------------------------------------------------

FAULTS = {
    # FaultPlan.random(seed=2, ...) of the reference's chaos gate compiles to this
    "kill": (FaultPlan.random(seed=2, n_workers=2, actions=("kill",)).compile(), {}),
    "stall": (FaultPlan.stall(0, 0).compile(), dict(stall_timeout_s=0.05, poll_s=0.01)),
    "delay": (FaultPlan.delay(0, 0, 0.01).compile(), dict(stall_timeout_s=0.05, poll_s=0.01)),
    "all_dead": ((FaultPlan.kill(0, 0) + FaultPlan.kill(1, 0)).compile(), {}),
}


@pytest.mark.parametrize("name", FAULTS)
def test_fault_plan_matches_the_reference(name, plans, baseline, monkeypatch):
    events, kw = FAULTS[name]
    local_devices = []
    real_eval_task = transport.eval_task

    def spy(payload, device=None):      # the front end's own evaluations
        local_devices.append(device)
        return real_eval_task(payload, device)

    monkeypatch.setattr(transport, "eval_task", spy)
    tsched, tids = _run_port(TSim(2, fault_events=events), plans[1], **kw)
    jsched, jids = _run_ref(JSim(2, fault_events=events), plans[0], **kw)
    got, want = _summary(tsched, tids), _summary(jsched, jids)
    assert got == want
    t = got["transport"]
    if name in ("kill", "stall"):
        assert t["worker_failures"] == 1 and t["redispatched_tasks"] >= 1
    elif name == "delay":
        assert t["worker_failures"] == 0
    else:
        assert t["local_fallbacks"] >= 1 and tsched.pool.alive_workers() == []
        assert local_devices and set(local_devices) == {torch.device("cpu")}
    for j, res in zip(tids, baseline):
        _assert_equal_results(tsched.jobs[j].result, res)


def _poison_b(real, X_b):
    """An ``eval_trial_megabatch`` that raises on any dispatch holding job
    b's cohort, recognized by its data (cohorts are rebuilt per process)."""
    def poisoned(cohorts):
        if any(np.isin(np.asarray(tc.ctx["X_tr"]).ravel()[:4], X_b).all()
               for tc in cohorts):
            raise RuntimeError("poison cohort")
        return real(cohorts)
    return poisoned


def test_mid_pack_failure_matches_the_reference(plans, baseline, monkeypatch):
    """A poison job in a remote megabatch fails alone in both packages: its
    co-rider re-runs solo and finishes with its fault-free result."""
    X_b = _tables()[1][0]
    monkeypatch.setattr(t_batched, "eval_trial_megabatch",
                        _poison_b(t_batched.eval_trial_megabatch, X_b))
    monkeypatch.setattr(j_batched, "eval_trial_megabatch",
                        _poison_b(j_batched.eval_trial_megabatch, X_b))
    tsched, tids = _run_port(TSim(2), plans[1])
    jsched, jids = _run_ref(JSim(2), plans[0])
    got = _summary(tsched, tids)
    assert got == _summary(jsched, jids)
    assert [j["phase"] for j in got["jobs"]] == ["done", "failed"]
    assert got["counters"]["poisoned_packs"] >= 1
    assert "poison" in repr(tsched.jobs[tids[1]].error)
    _assert_equal_results(tsched.jobs[tids[0]].result, baseline[0])


def test_whole_group_failure_matches_the_reference(plans):
    def always_broken(cohorts):
        raise RuntimeError("backend down")

    with mock.patch.object(t_batched, "eval_trial_megabatch", always_broken), \
            mock.patch.object(j_batched, "eval_trial_megabatch", always_broken):
        tsched, tids = _run_port(TSim(2), plans[1])
        jsched, jids = _run_ref(JSim(2), plans[0])
    got = _summary(tsched, tids)
    assert got == _summary(jsched, jids)
    assert [j["phase"] for j in got["jobs"]] == ["failed", "failed"]


# ---------------------------------------------------------------------------
# checkpoints and snapshots
# ---------------------------------------------------------------------------


def test_checkpointed_front_end_resumes_bit_identically(tmp_path, plans, baseline):
    """Kill the front end mid-flight; a fresh one restores the last per-step
    checkpoint and finishes with the fault-free results."""
    ckpt = tmp_path / "ckpt"
    sched = TDist(TSim(2), cache=TCache(), ckpt_dir=ckpt, device="cpu")
    ids = _submit_two(sched, plans[1])
    sched.step()        # factorize → dst → the first sub_automl rung
    assert any(j.search is not None for j in sched.jobs.values())
    del sched

    fresh = TDist(TSim(2), cache=TCache(), ckpt_dir=ckpt, device="cpu")
    assert fresh.resume() == 1
    assert set(fresh.jobs) == set(ids)
    for job in fresh.jobs.values():
        assert job.coded.codes.device == torch.device("cpu")
        assert job.search.ctx["device"] == torch.device("cpu")
    fresh.run()
    for j, want in zip(ids, baseline):
        assert fresh.jobs[j].phase == "done"
        _assert_equal_results(fresh.jobs[j].result, want)
    assert TDist(TSim(1), cache=TCache(), device="cpu").resume() is None


def test_snapshot_preserves_leaderboard_counters_and_state(plans):
    sched = TSched(TCache(), device="cpu")
    a, b = _submit_two(sched, plans[1])
    sched.run()
    fresh = TSched(TCache(), device="cpu")
    fresh.load_snapshot(sched.snapshot())
    assert fresh.jobs[a].leaderboard == sched.jobs[a].leaderboard
    assert fresh.jobs[a].spans == sched.jobs[a].spans
    for k in _COUNTERS:
        assert getattr(fresh, k) == getattr(sched, k)
    assert fresh._next_id == sched._next_id
    assert fresh.metrics.to_dict() == sched.metrics.to_dict()
    assert (wire.dumps(fresh.experience.state_dict())
            == wire.dumps(sched.experience.state_dict()))
    for j in (a, b):
        got, want = fresh.jobs[j].result, sched.jobs[j].result
        assert got.final.spec == want.final.spec and got.final.trials == want.final.trials
        for x, y in zip(_leaves(got.final.params), _leaves(want.final.params)):
            assert isinstance(x, torch.Tensor) and torch.equal(x, y)
    # the DST cache came along: a repeat submission is a hit
    X, y, Xt, yt = _tables()[0]
    c = fresh.submit(X, y, seed=9, plan=plans[1], X_test=Xt, y_test=yt)
    fresh.run()
    assert fresh.jobs[c].cache_hit and fresh.jobs[c].phase == "done"


# ---------------------------------------------------------------------------
# pools: devices, boots and refusals
# ---------------------------------------------------------------------------


def test_cuda_pool_refuses_fork(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="fork"):
        ProcessWorkerPool(1, device="cuda", start_method="fork")


def test_worker_that_cannot_resolve_the_device_fails_the_boot(monkeypatch):
    """A spawned worker asked for CUDA on a machine without a card raises at
    boot (the front end is made to believe it has one), so the pool's boot
    fails: no worker quietly computes on the CPU."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "library", lambda: None)
    with pytest.raises(RuntimeError, match="died at boot"):
        ProcessWorkerPool(1, device="cuda", ready_timeout_s=120.0)


def _hello_from_cuda(w, task_q, result_q, fault_events, device):
    result_q.put(("hello", w, 0.0, "cuda"))


def test_hello_from_another_device_fails_the_boot(monkeypatch):
    """The pool holds each hello's device to the asked one (forked, so the
    stand-in worker runs)."""
    monkeypatch.setattr(transport, "worker_main", _hello_from_cuda)
    with pytest.raises(RuntimeError, match="resolved device 'cuda', not 'cpu'"):
        ProcessWorkerPool(1, device="cpu", start_method="fork", ready_timeout_s=60.0)


@pytest.mark.slow
def test_process_pool_chaos_with_http(plans, baseline, capfd, monkeypatch):
    """The kill scenario against real spawned workers on the CPU, served over
    HTTP: worker 0 dies mid-protocol (os._exit), the front end re-dispatches
    to the survivor, and both jobs finish with the fault-free results.  The
    workers import neither JAX nor the reference (``-X importtime`` lists
    every module they import)."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    pool = ProcessWorkerPool(2, device="cpu",
                             fault_events=FaultPlan.kill(0, 0).compile())
    monkeypatch.delenv("PYTHONPROFILEIMPORTTIME")
    assert sorted(pool.boot_s) == [0, 1]
    sched = TDist(pool, cache=TCache(), stall_timeout_s=60.0, device="cpu")
    http = SubStratHTTPServer(SubStratServer(scheduler=sched)).start()
    try:
        client = SubStratHTTPClient(http.url)
        ids = [client.submit(X, y, seed=i + 1, plan=plans[1], X_test=Xt, y_test=yt)
               for i, (X, y, Xt, yt) in enumerate(_tables())]
        assert len(list(client.stream_leaderboard(ids[0]))) >= 2
        for j, want in zip(ids, baseline):
            got = client.result(j)
            assert got.final.spec == want.final.spec
            np.testing.assert_allclose([v for _, v in got.final.trials],
                                       [v for _, v in want.final.trials], atol=1e-6)
            np.testing.assert_array_equal(got.row_idx, want.row_idx)
        stats = client.stats()
        assert stats["transport"]["worker_failures"] == 1
        assert stats["transport"]["redispatched_tasks"] >= 1
        assert "worker_failures_total 1" in client.metrics()
        spans = client.trace(ids[0])["spans"]
        assert any(s["name"] == "dispatch" and s["attempt"] == 1 for s in spans)
    finally:
        http.close()
        sched.close()
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in capfd.readouterr().err.splitlines()
                if line.startswith("import time:")]
    assert "torch" in imported and "repro_torch.service.worker" in imported
    assert not [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "repro")]
