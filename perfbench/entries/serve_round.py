"""Entry adapter: many models, one AutoML model per partition of one table,
served together through ``repro_torch.service.SubStratServer``.

A job is one round.  The job's training table (a row permutation of the
mix's table) is cut in order into the configuration's partitions, sized by
Zipf shares of its rows; each partition is submitted to a fresh in-process
server as a job of its own, with the shared held-out rows and the seed
``job seed x partitions + k``; then ``run()`` drives them all to their
final models inside one ``obs.trace.collect`` sink.  The server merges the
partitions' AutoML rungs across jobs (megabatches, padded where their
shapes differ) and batches subset searches only where the coded tables
share a shape.

Each partition is checked as ``entries/execute.py`` checks one job, by an
``execute`` adapter at the partition's shape (the module is loaded, not
copied).  A round's number is each number's reading over its partitions
as ``compare.verdict`` reads a run's jobs: the worst partition's, and the
sum over the partitions for the row counts (``compare.summed``).

To check the coded tables the adapter wraps the ``factorize`` that the
scheduler calls: the wrapper returns the program's own result and, for the
rounds the run checks, keeps a reference to it.  It adds no device work.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from pbcore import compare as C
from pbcore.spec import load_module

EXECUTE = load_module(Path(__file__).resolve().parent / "execute.py")

PHASES = ("factorize", "gen_dst", "automl")
# the round's phase seconds, by the partitions' ``times`` keys
TIME_KEYS = {"factorize": ("factorize_s",), "gen_dst": ("gen_dst_s",),
             "automl": ("automl_sub_s", "fine_tune_s")}


def partition_sizes(n_rows: int, partitions: int, zipf_s: float) -> list:
    """Rows of each partition: Zipf shares ``k ** -s`` of ``n_rows``,
    rounded; the largest takes what the rounding leaves over."""
    w = 1.0 / np.arange(1, partitions + 1, dtype=np.float64) ** zipf_s
    sizes = np.floor(n_rows * w / w.sum() + 0.5).astype(np.int64)
    sizes[0] += n_rows - sizes.sum()
    return [int(v) for v in sizes]


class Entry:
    phases = PHASES

    def __init__(self, config: dict, table, device):
        import repro_torch.service.scheduler as sched_mod
        from repro_torch.obs import trace
        from repro_torch.service import SubStratServer
        self.config, self.device = config, device
        dep = config["deployment"]
        self.k = int(dep["partitions"])
        sizes = partition_sizes(len(table.y_tr), self.k, float(dep["zipf_s"]))
        self.bounds = np.concatenate([[0], np.cumsum(sizes)])
        # one execute adapter per partition: its plan at the partition's
        # subset shape, and its checks
        self.parts = [EXECUTE.Entry(config, table._replace(X_tr=table.X_tr[a:b],
                                                           y_tr=table.y_tr[a:b]), device)
                      for a, b in zip(self.bounds[:-1], self.bounds[1:])]
        self._server = lambda: SubStratServer(device=device, **config["server"])
        self._collect = trace.collect
        self._factorize = getattr(sched_mod.factorize, "__wrapped__", sched_mod.factorize)
        self._kept = None

        def factorize_kept(X, *args, **kwargs):
            coded = self._factorize(X, *args, **kwargs)
            if self._kept is not None:
                self._kept[id(X)] = coded
            return coded

        factorize_kept.__wrapped__ = self._factorize
        sched_mod.factorize = factorize_kept

    def split(self, X, y, seed: int) -> list:
        """(X_k, y_k, seed_k) of each partition of one round's table."""
        return [(X[a:b], y[a:b], int(seed) * self.k + i)
                for i, (a, b) in enumerate(zip(self.bounds[:-1], self.bounds[1:]))]

    def job(self, X, y, X_te, y_te, seed: int, keep: bool) -> dict:
        parts = self.split(X, y, seed)
        srv = self._server()
        ids = [srv.submit(Xk, yk, tenant=f"p{i}", seed=sk, plan=self.parts[i].plan,
                          X_test=X_te, y_test=y_te)
               for i, (Xk, yk, sk) in enumerate(parts)]
        sink = []
        self._kept = {} if keep else None
        try:
            with self._collect(sink):
                srv.run()
            kept = self._kept
        finally:
            self._kept = None
        jobs = [srv.scheduler.jobs[j] for j in ids]
        return {"results": [srv.result(j) for j in ids],
                "spans": sink + [sp for jb in jobs for sp in jb.spans],
                "coded": [kept.get(id(Xk)) if kept else None for Xk, _, _ in parts],
                "seed": seed}

    @staticmethod
    def test_acc(rec) -> float:
        return float(np.mean([r.final.test_acc for r in rec["results"]]))

    @staticmethod
    def phase_seconds(rec) -> dict:
        return {ph: float(sum(r.times.get(key, 0.0) for r in rec["results"] for key in keys))
                for ph, keys in TIME_KEYS.items()}

    def _part_record(self, rec, i: int) -> dict:
        return {"result": rec["results"][i], "coded": rec["coded"][i],
                "seed": int(rec["seed"]) * self.k + i}

    def passes(self, rec, X, y) -> list:
        """Every AutoML pass of the round's partitions."""
        return [p for i, (Xk, yk, _) in enumerate(self.split(X, y, rec["seed"]))
                for p in self.parts[i].passes(self._part_record(rec, i), Xk, yk)]

    def answers(self, rec) -> list:
        return [self.parts[i].answers(self._part_record(rec, i)) for i in range(self.k)]

    def compare(self, X, y, X_te, y_te, seed, ans, dev) -> dict:
        readings = [self.parts[i].compare(Xk, yk, X_te, y_te, sk, ans[i], dev)
                    for i, (Xk, yk, sk) in enumerate(self.split(X, y, seed))]
        return C.verdict(readings, {})[1]

    def control(self, X, y, X_te, y_te, seed, ans, dev) -> list:
        return [self.parts[i].control(Xk, yk, X_te, y_te, sk, ans[i], dev)
                for i, (Xk, yk, sk) in enumerate(self.split(X, y, seed))]
