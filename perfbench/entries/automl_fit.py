"""Entry adapter: Full-AutoML, ``repro_torch.automl.engine.automl_fit``.

A job is one AutoML search over the job's whole training table, scored on
the held-out rows: the paper's baseline.
"""
from __future__ import annotations

import time

from pbcore import compare as C
from pbcore import reference as R

PHASES = ("automl_fit",)


class Entry:
    phases = PHASES

    def __init__(self, config: dict, table, device):
        from repro_torch.automl.engine import AutoMLConfig, automl_fit
        self.config, self.device = config, device
        cfg = dict(config["automl"])
        cfg["rungs"] = tuple(cfg["rungs"])
        self.automl_config = AutoMLConfig(**cfg)
        self._fit = automl_fit

    def job(self, X, y, X_te, y_te, seed: int, keep: bool) -> dict:
        t0 = time.time()
        res = self._fit(X, y, config=self.automl_config, X_test=X_te, y_test=y_te,
                        device=self.device)
        span = {"name": "automl_fit", "t0": t0, "t1": time.time()}
        return {"result": res, "spans": [span], "seed": seed}

    @staticmethod
    def test_acc(rec) -> float:
        return float(rec["result"].test_acc)

    @staticmethod
    def phase_seconds(rec) -> dict:
        return {"automl_fit": float(rec["result"].time_s)}

    def passes(self, rec, X, y) -> list:
        return [(rec["result"], self.config["automl"], X.shape)]

    def answers(self, rec) -> dict:
        return {"full": C.pass_answers(rec["result"])}

    def _pass(self, X, y, X_te, y_te, dev):
        return R.Pass(X, y, self.config["automl"], None, dev, X_te, y_te)

    def compare(self, X, y, X_te, y_te, seed, ans, dev) -> dict:
        return C.compare_pass(self._pass(X, y, X_te, y_te, dev), ans["full"], "")

    def control(self, X, y, X_te, y_te, seed, ans, dev) -> dict:
        return {"full": C.control_pass(self._pass(X, y, X_te, y_te, dev), ans["full"])}
