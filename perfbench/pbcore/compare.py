"""The comparison that decides ``correct``.

Each checked job's answers go through ``compare_*`` against the plain
reference (``reference.py``), which gives named numbers; ``verdict`` holds
each number's worst reading over the checked jobs against the cell's limit
(``perfbench/limits/<workload>.json``).  The control (``control_*``) puts the
reference, computed in the precision below the configuration's, in the
program's place: its answers go through the same comparison.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from . import reference as R


def rows(share: float, n: int) -> int:
    """An accuracy reported as a float32 share of ``n`` rows, as a count."""
    return int(round(float(share) * n))


def pass_answers(res) -> dict:
    """What one AutoML pass answered: its trial log, its winner's spec and
    parameters, and the accuracies it reports."""
    return {
        "trials": [(R.spec_key(s), float(v)) for s, v in res.trials],
        "winner": R.spec_key(res.spec),
        "params": res.params,
        "val_acc": float(res.val_acc),
        "test_acc": None if res.test_acc is None else float(res.test_acc),
    }


def _cohorts(P: R.Pass, trials: list) -> Optional[List[list]]:
    """The trial log split into rungs, or None if it does not fit the
    population's rung sizes."""
    sizes, out, i = P.rung_sizes(), [], 0
    for s in sizes:
        out.append(trials[i:i + s])
        i += s
    if i != len(trials) or any(spec not in P.index for spec, _ in trials):
        return None
    return out


def compare_pass(P: R.Pass, ans: dict, prefix: str) -> Dict[str, float]:
    """Numbers of one AutoML pass: the validation rows on which the trials'
    reported accuracies and the reference's retraining of each at its rung
    differ, summed over the Adam-trained trials (``trial_rows``) and over the
    closed-form ones (``closed_rows``); the winner's parameters against
    the reference's; the winner's validation and test rows recomputed from its
    own parameters; and structural faults (a log that is not the population's
    successive halving, a winner that is not the best of the last rung)."""
    faults = 0
    cohorts = _cohorts(P, ans["trials"])
    n_val = len(P.y_val)
    trial_rows, closed_rows, ref_winner = 0, 0, None
    if cohorts is None:
        faults += 1
        trial_rows = closed_rows = math.inf
    else:
        last = len(cohorts) - 1
        accs = [v for _, v in cohorts[last]]
        if not accs or cohorts[last][int(np.argmax(accs))][0] != ans["winner"]:
            faults += 1
        for r, cohort in enumerate(cohorts):
            for spec, v in cohort:
                ref = P.train_trial(spec, r, "float32")
                gap = abs(rows(v, n_val) - P.correct(spec, ref, "val"))
                if spec[2] in R.CLOSED_FORM:
                    closed_rows += gap
                else:
                    trial_rows += gap
                if r == last and spec == ans["winner"]:
                    ref_winner = ref
    out = {
        prefix + "trial_rows": float(trial_rows),
        prefix + "closed_rows": float(closed_rows),
        prefix + "winner_gap": (math.inf if ref_winner is None
                                else R.params_gap(ans["params"], ref_winner)),
        prefix + "val_rows": float(abs(rows(ans["val_acc"], n_val)
                                       - P.correct(ans["winner"], ans["params"], "val"))),
    }
    if P.y_test is not None:
        out[prefix + "test_rows"] = (
            math.inf if ans["test_acc"] is None else
            float(abs(rows(ans["test_acc"], len(P.y_test))
                      - P.correct(ans["winner"], ans["params"], "test"))))
    out[prefix + "faults"] = float(faults)
    return out


def control_pass(P: R.Pass, ans: dict) -> dict:
    """The control's answers for one pass: every trial of the program's log
    and its winner retrained by the reference in the lower precision, the
    accuracies computed in it too."""
    cohorts = _cohorts(P, ans["trials"]) or []
    n_val = len(P.y_val)
    trials, params = [], None
    for r, cohort in enumerate(cohorts):
        for spec, _ in cohort:
            p = P.train_trial(spec, r, "lower")
            trials.append((spec, P.correct(spec, p, "val", "lower") / n_val))
            if r == len(cohorts) - 1 and spec == ans["winner"]:
                params = p
    out = dict(ans, trials=trials, params=params)
    out["val_acc"] = P.correct(ans["winner"], params, "val", "lower") / n_val
    if P.y_test is not None:
        out["test_acc"] = P.correct(ans["winner"], params, "test", "lower") / len(P.y_test)
    return out


def compare_codes(ref_codes, ref_meta, codes, meta) -> float:
    """Entries of the coded table (and of its bin counts, target column and
    width) that differ from the reference's."""
    if codes.shape != ref_codes.shape:
        return math.inf
    bad = int((codes != ref_codes).sum()) + int((np.asarray(meta[0]) != ref_meta[0]).sum())
    return float(bad + (meta[1] != ref_meta[1]) + (meta[2] != ref_meta[2]))


def subset_faults(rows_idx, col_idx, N: int, M: int, n: int, m: int, target: int) -> int:
    """Faults of a returned subset: not ``n`` rows of the table, or not
    ``m - 1`` distinct feature columns (the target is the ``m``-th).  Rows
    may repeat: Gen-DST replaces a duplicate slot with one fresh draw, which
    can itself collide (the JAX package's ``_dedup_rows`` does the same), and
    the fitness counts a repeated row twice on both sides."""
    r, c = np.asarray(rows_idx, np.int64), np.asarray(col_idx, np.int64)
    faults = int(len(r) != n)
    faults += int(r.size and (r.min() < 0 or r.max() >= N))
    faults += int(len(c) != m - 1) + int(len(np.unique(c)) != len(c))
    faults += int(c.size and (c.min() < 0 or c.max() >= M or (c == target).any()))
    return faults


def summed(key: str) -> bool:
    """Whether a number is a count summed over the run's checked jobs (the
    trials' row gaps: a row or two a job, too coarse for one job alone)
    rather than the worst job's reading."""
    return key.endswith("trial_rows") or key.endswith("closed_rows")


def verdict(readings: List[Dict[str, float]], limits: Dict[str, float]):
    """(correct, the run's reading of each number, failures) over the checked
    jobs.  A number with no limit, a limit with no number, or no job checked
    is a failure."""
    worst: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            worst[k] = (worst.get(k, 0.0) + float(v) if summed(k)
                        else max(worst.get(k, -math.inf), float(v)))
    fails = [k for k in sorted(set(worst) | set(limits))
             if k not in limits or k not in worst or not worst[k] <= limits[k]]
    return (bool(readings) and not fails), worst, fails
