"""Entry adapter: SubStrat's pipeline, ``repro_torch.core.plan.execute``.

A job is one ``execute`` of the configuration's ``plan("gen_dst")`` on the
job's training table: factorize, Gen-DST, the sub-AutoML pass on the subset,
the fine-tune on the full table, the test accuracy on the held-out rows.

To check the coded table the adapter wraps the ``factorize`` that ``execute``
calls: the wrapper returns the program's own result and, for the jobs the
run checks, keeps a reference to it.  It adds no device work.
"""
from __future__ import annotations

import math

import numpy as np

from pbcore import compare as C
from pbcore import reference as R

PHASES = ("factorize", "gen_dst", "sub_automl", "fine_tune")
# execute()'s phase seconds, by span name
TIME_KEYS = {"factorize": "factorize_s", "gen_dst": "gen_dst_s",
             "sub_automl": "automl_sub_s", "fine_tune": "fine_tune_s"}


def subset_shape(N: int, M: int) -> tuple:
    """The paper's subset shape: sqrt(N) rows and a quarter of the M
    columns, the target counted."""
    return int(math.floor(math.sqrt(N) + 0.5)), int(math.floor(0.25 * M + 0.5))


class Entry:
    phases = PHASES

    def __init__(self, config: dict, table, device):
        import importlib
        from repro_torch.automl.engine import AutoMLConfig
        from repro_torch.core.gen_dst import GenDSTConfig
        plan_mod = importlib.import_module("repro_torch.core.plan")
        self.config, self.device = config, device
        N, d = table.X_tr.shape
        self.n, self.m = subset_shape(N, d + 1)
        p = config["plan"]
        self.plan = plan_mod.plan(
            p["strategy"], n=self.n, m=self.m, fine_tune=p["fine_tune"],
            sub_automl=AutoMLConfig(**_automl(config["sub_automl"])),
            ft_automl=AutoMLConfig(**_automl(config["ft_automl"])),
            continuous_batching=p["continuous_batching"], warm_start=p["warm_start"],
            cfg=GenDSTConfig(**config["gen_dst"]))
        self._execute = plan_mod.execute
        self._factorize = getattr(plan_mod.factorize, "__wrapped__", plan_mod.factorize)
        self._keep = False
        self._kept = None

        def factorize_kept(*args, **kwargs):
            coded = self._factorize(*args, **kwargs)
            if self._keep:
                self._kept = coded
            return coded

        factorize_kept.__wrapped__ = self._factorize
        plan_mod.factorize = factorize_kept

    def job(self, X, y, X_te, y_te, seed: int, keep: bool) -> dict:
        spans = []
        self._keep, self._kept = keep, None
        res = self._execute(self.plan, X, y, seed=seed, X_test=X_te, y_test=y_te,
                            trace_sink=spans, device=self.device)
        rec = {"result": res, "spans": spans, "coded": self._kept, "seed": seed}
        self._kept = None
        return rec

    @staticmethod
    def test_acc(rec) -> float:
        return float(rec["result"].final.test_acc)

    @staticmethod
    def phase_seconds(rec) -> dict:
        t = rec["result"].times
        return {ph: float(t.get(key, 0.0)) for ph, key in TIME_KEYS.items()}

    def passes(self, rec, X, y) -> list:
        """(AutoML result, its config, the rows and features it was given)
        per AutoML pass of the job."""
        res = rec["result"]
        X_sub, _ = R.build_subset(X, y, res.row_idx, res.col_idx, rec["seed"] ^ 0x5AB5)
        return [(res.intermediate, self.config["sub_automl"], X_sub.shape),
                (res.final, self.config["ft_automl"], X.shape)]

    def answers(self, rec) -> dict:
        from repro_torch.core.measures import host_codes
        res = rec["result"]
        ans = {"rows": np.asarray(res.row_idx), "cols": np.asarray(res.col_idx),
               "fitness": float(res.dst_fitness),
               "sub": C.pass_answers(res.intermediate), "ft": C.pass_answers(res.final)}
        if rec["coded"] is not None:
            coded = rec["coded"]
            codes, n_bins = host_codes(coded)
            ans["codes"] = (np.array(codes), (np.array(n_bins), coded.target_col, coded.max_bins))
        return ans

    def _passes(self, X, y, X_te, y_te, seed, ans, dev):
        X_sub, y_sub = R.build_subset(X, y, ans["rows"], ans["cols"], seed ^ 0x5AB5)
        sub = R.Pass(X_sub, y_sub, self.config["sub_automl"], None, dev)
        ft = R.Pass(X, y, self.config["ft_automl"], ans["sub"]["winner"][2], dev, X_te, y_te)
        return sub, ft

    def compare(self, X, y, X_te, y_te, seed, ans, dev) -> dict:
        codes, n_bins, target, B = R.factorize(X, y, "float32")
        out = {}
        if "codes" in ans:
            out["codes_diff"] = C.compare_codes(codes, (n_bins, target, B), *ans["codes"])
        mask = np.zeros(codes.shape[1], bool)
        mask[ans["cols"]] = True
        mask[target] = True
        faults = C.subset_faults(ans["rows"], ans["cols"], len(y), X.shape[1], self.n, self.m,
                                 target)
        out["subset_faults"] = float(faults)
        out["fitness_gap"] = (math.inf if faults else
                              abs(ans["fitness"] - R.dst_fitness(codes, B, ans["rows"], mask)))
        sub, ft = self._passes(X, y, X_te, y_te, seed, ans, dev)
        out.update(C.compare_pass(sub, ans["sub"], "sub."))
        out.update(C.compare_pass(ft, ans["ft"], "ft."))
        return out

    def control(self, X, y, X_te, y_te, seed, ans, dev) -> dict:
        codes, n_bins, target, B = R.factorize(X, y, "lower")
        mask = np.zeros(codes.shape[1], bool)
        mask[ans["cols"]] = True
        mask[target] = True
        sub, ft = self._passes(X, y, X_te, y_te, seed, ans, dev)
        out = dict(ans, codes=(codes, (n_bins, target, B)),
                   fitness=R.dst_fitness(codes, B, ans["rows"], mask, "lower"),
                   sub=C.control_pass(sub, ans["sub"]), ft=C.control_pass(ft, ans["ft"]))
        return out


def _automl(cfg: dict) -> dict:
    out = dict(cfg)
    out["rungs"] = tuple(out["rungs"])
    return out
