"""The service and its multi-process tier on a card, at a small size: what
they add to a job is logic (merges, a cache hit, a warm start, a killed
worker, a resume), so the tables are small and the plan is the paper's
``plan("gen_dst")``.

* One ``SubStratServer(batch_dst=True)`` on the card serves five jobs of
  four tenants, all submitted before the first step: a table A, two more of
  its spec with other dataset seeds (their searches merge into one
  ``gen_dst_batch``), A again (a cache hit that waits for the leader's
  winner family), and a table of another shape (searched solo).  B1 and B2
  launched once per generation for the merged group and once per
  generation for the other shape; each merged subset equal to its solo run;
  each DST fitness equal to a plain recomputation; one cache hit, three
  merged searches, a megabatch spanning jobs; each table coded on the card
  hashes to its job's fingerprint; the metrics text parses and holds every
  family the scheduler registers; no kernel built during the run.  Then a
  sixth job starts from the portfolio with fewer rung-0 trials than a cold
  one.
* A ``DistributedScheduler`` behind ``SubStratHTTPServer`` with two worker
  processes on the card, worker 0 killed at its first task, serves three of
  those jobs over HTTP: each equal to the in-process ``Scheduler``'s
  (bit-equal, else trial accuracies within 2/N_val); one worker failure and
  a re-dispatch; B1 and B2 launched in the front end only; a streamed
  leaderboard; the transport's metric families; a retry dispatch with the
  worker's deserialize, eval and serialize children.  Then a checkpointed
  front end stops after step 2 and a fresh one on a new pool resumes it to
  the in-process results.

Every case is marked ``cuda`` and skips without a card.  No JAX:

    python -m pytest -q -m cuda tests/test_torch_service_card.py

Spawned workers import the process's main module: pytest's keeps its work
under ``if __name__ == "__main__"``.
"""
import math
import re

import numpy as np
import pytest
import torch

from _card import finite_acc, plain_fitness, requires_cuda, skip_without_cuda
from _port_cases import fleet_tables
from repro_torch import kernels as K
from repro_torch.core.gen_dst import GenDSTConfig
from repro_torch.core.measures import factorize
from repro_torch.core.plan import execute, plan

pytestmark = requires_cuda

FIT_TOL = 1e-6
# (tenant, job seed) of the five served jobs, in the order of fleet_tables()
JOBS = (("alpha", 0), ("beta", 1), ("gamma", 2), ("alpha", 3), ("delta", 4))
# one line of the Prometheus text exposition: a sample, or a HELP/TYPE comment
SAMPLE_LINE = r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? (-?[0-9.]+(e[+-]?[0-9]+)?|[+-]Inf|NaN)"
COMMENT_LINE = r"# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .*"
# the multi-process tier's families in its metrics text (DESIGN.md §14.5)
TRANSPORT_FAMILIES = ("remote_tasks_total", "redispatched_tasks_total",
                      "heartbeat_misses_total", "worker_failures_total")


@pytest.fixture(scope="module")
def tables():
    skip_without_cuda()
    return fleet_tables()


def _typed_families(text):
    """The metric families a Prometheus text declares; every line must parse."""
    for line in text.splitlines():
        assert re.fullmatch(SAMPLE_LINE, line) or re.fullmatch(COMMENT_LINE, line), line
    return set(re.findall(r"^# TYPE (\S+) ", text, re.M))


def test_served_fleet_on_card(tables):
    skip_without_cuda()
    from repro_torch.obs import torchprof
    from repro_torch.service import Scheduler, SubStratServer, dataset_fingerprint
    pl = plan("gen_dst")
    psi = GenDSTConfig().psi
    jobs = tables[:5]
    solo = [execute(pl, X, y, seed=seed, X_test=Xt, y_test=yt, device="cuda")
            for (_t, seed), (X, y, Xt, yt) in zip(JOBS, jobs)]

    snap = torchprof.tracing_snapshot()
    server = SubStratServer(device="cuda", batch_dst=True)
    K.reset_launch_counts()
    ids = [server.submit(X, y, tenant=tenant, seed=seed, plan=pl, X_test=Xt, y_test=yt)
           for (tenant, seed), (X, y, Xt, yt) in zip(JOBS, jobs)]
    results = [server.result(i) for i in ids]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    stats = server.stats()
    metrics = stats["metrics"]

    for jid, res in zip(ids, results):
        assert server.poll(jid).phase == "done" and finite_acc(res.final.test_acc)
    # once per generation (and the initial population) for the merged group
    # and for the table of another shape; none for the cache hit
    assert launches["masked_histogram"] == launches["fused_delta_fitness"] == 2 * (psi + 1)
    for j in range(3):
        assert np.array_equal(results[j].row_idx, solo[j].row_idx)
        assert np.array_equal(results[j].col_idx, solo[j].col_idx)
        assert results[j].dst_fitness == solo[j].dst_fitness
    hit = server.poll(ids[3])
    assert hit.cache_hit and hit.warm_started
    assert np.array_equal(results[3].row_idx, results[0].row_idx)
    assert results[3].final.spec.family == results[0].intermediate.spec.family
    assert metrics["cache_hits_total"]["value"] == 1 and stats["merged_dst"] == 3
    assert metrics["dispatches_total"]["values"].get("merged", 0) >= 1
    coded = {}
    for jid, res, (X, y, _xt, _yt) in zip(ids, results, jobs):
        c = coded.setdefault(id(X), factorize(X, y, device="cuda"))
        assert dataset_fingerprint(c) == server.scheduler.jobs[jid].fingerprint
        assert abs(res.dst_fitness - plain_fitness(c, res.row_idx, res.col_idx)) <= FIT_TOL
    families = set(Scheduler(device="cuda").metrics.to_dict()) | {
        "torch_kernel_builds_total", "kernel_launches_total"}
    assert families <= _typed_families(server.metrics_text())
    assert not torchprof.new_tracings_since(snap)

    # a sixth job once four fingerprints have trained: seeded from the portfolio
    X, y, Xt, yt = tables[5]
    wid = server.submit(X, y, tenant="beta", seed=5, plan=pl, X_test=Xt, y_test=yt)
    wres = server.result(wid)
    m = server.scheduler.metrics.to_dict()
    warm0 = server.poll(wid).leaderboard[0]["trials_done"]
    cold0 = server.poll(ids[0]).leaderboard[0]["trials_done"]
    assert m["portfolio_hits_total"]["value"] == 1 and warm0 < cold0
    assert finite_acc(wres.final.test_acc)


def _same_results(got, want):
    """The parts of two ``SubStratResult``s that differ: subset, fitness,
    winner specs and trial accuracies (empty if all are bit-equal)."""
    diff = []
    if not (np.array_equal(got.row_idx, want.row_idx)
            and np.array_equal(got.col_idx, want.col_idx)):
        diff.append("subset")
    if got.dst_fitness != want.dst_fitness:
        diff.append("dst_fitness")
    for name in ("intermediate", "final"):
        g, w = getattr(got, name), getattr(want, name)
        if g.spec != w.spec:
            diff.append(f"{name} spec")
        if [v for _, v in g.trials] != [v for _, v in w.trials]:
            diff.append(f"{name} trial accuracies")
        if g.test_acc != w.test_acc:
            diff.append(f"{name} test_acc")
    return diff


def _trial_gap(got, want, n_train):
    """The largest trial-accuracy gap of two results' AutoML passes, in units
    of 2/N_val of each pass; inf if the two ran other trials."""
    gap = 0.0
    for name, n_rows in (("intermediate", len(want.row_idx)), ("final", n_train)):
        g, w = getattr(got, name), getattr(want, name)
        if [s for s, _ in g.trials] != [s for s, _ in w.trials]:
            return math.inf
        n_val = max(1, int(0.2 * n_rows))
        for (_s, a), (_t, b) in zip(g.trials, w.trials):
            gap = max(gap, abs(a - b) / (2.0 / n_val))
    return gap


def _assert_as_in_process(results, want, jobs):
    """Each job done with a finite test accuracy and bit-equal to the
    in-process run, or differing only in trial accuracies within 2/N_val."""
    for got, ref, (_X, y, _xt, _yt) in zip(results, want, jobs):
        assert finite_acc(got.final.test_acc)
        diff = _same_results(got, ref)
        assert "subset" not in diff and "dst_fitness" not in diff, diff
        assert not diff or _trial_gap(got, ref, len(y)) <= 1.0, diff


def test_workers_on_card_with_a_kill_and_a_resume(tables, tmp_path):
    skip_without_cuda()
    from repro_torch.service import (
        DistributedScheduler, ProcessWorkerPool, Scheduler, SubStratHTTPClient,
        SubStratHTTPServer, SubStratServer,
    )
    pl = plan("gen_dst")
    psi = GenDSTConfig().psi
    jobs = [tables[0], tables[1], tables[4]]
    names = [JOBS[0], JOBS[1], JOBS[4]]

    def submit_all(submit):
        return [submit(X, y, tenant=tenant, seed=seed, plan=pl, X_test=Xt, y_test=yt)
                for (tenant, seed), (X, y, Xt, yt) in zip(names, jobs)]
    sched = Scheduler(batch_dst=True, device="cuda")
    want = [sched.jobs[i] for i in submit_all(sched.submit)]
    sched.run()
    want = [j.result for j in want]

    pool_a = ProcessWorkerPool(2, device="cuda", fault_events=((0, 0, "kill", 0.0),))
    assert pool_a.device.type == "cuda" and sorted(pool_a.boot_s) == [0, 1]
    try:
        front = DistributedScheduler(pool_a, batch_dst=True, stall_timeout_s=120.0,
                                     device="cuda")
        http = SubStratHTTPServer(SubStratServer(scheduler=front)).start()
        try:
            client = SubStratHTTPClient(http.url)
            K.reset_launch_counts()
            ids = submit_all(client.submit)
            board = list(client.stream_leaderboard(ids[0]))
            results = [client.result(i) for i in ids]
            launches = K.launch_counts()
            _assert_as_in_process(results, want, jobs)
            tr = client.stats()["transport"]
            assert tr["worker_failures"] == 1 and tr["redispatched_tasks"] >= 1
            # the merged pair's generations and the other shape's, all in the front end
            assert launches["masked_histogram"] == launches["fused_delta_fitness"] == 2 * (psi + 1)
            assert len(board) >= 2
            assert set(TRANSPORT_FAMILIES) <= _typed_families(client.metrics())
            retried = 0
            for jid in ids:
                spans = client.trace(jid)["spans"]
                retry = [s for s in spans if s["name"] == "dispatch" and s["attempt"] >= 1]
                if retry:
                    kids = {s["name"] for s in spans if s.get("parent_id") == retry[0]["span_id"]}
                    assert {"deserialize", "eval", "serialize"} <= kids
                    retried += 1
            assert retried >= 1
        finally:
            http.close()

        # a checkpointed front end stops after step 2; a fresh one on a new pool resumes
        first = DistributedScheduler(pool_a, batch_dst=True, ckpt_dir=tmp_path, device="cuda")
        submit_all(first.submit)
        first.step()
        first.step()
    finally:
        pool_a.close()
    pool_b = ProcessWorkerPool(2, device="cuda")
    try:
        resumed = DistributedScheduler(pool_b, batch_dst=True, ckpt_dir=tmp_path, device="cuda")
        assert resumed.resume() == 2
        resumed.run()
        _assert_as_in_process([resumed.jobs[i].result for i in sorted(resumed.jobs)], want, jobs)
    finally:
        pool_b.close()
