"""The tables a traffic mix sends, and the jobs a run draws from its seed.

A frozen copy of ``make_dataset`` and ``train_test_split`` from the port's
``src/repro_torch/data/tabular.py`` (itself a copy of the JAX package's
``data/tabular.py``), seeded from the mix's ``table_seed``: a mix is one
table, as each of the paper's datasets is.  Kept here so that a change to
the program's generator cannot change the benchmark's inputs.

A mix also fixes a pool of ``job_pool`` job inputs, each the training table
under a row permutation of its own with a seed of its own, both drawn from
(``table_seed``, pool index).  The run's ``--seed`` draws the order: the
window walks the pool in cycles, each cycle a fresh permutation of the pool
drawn from (``--seed``, cycle).  So every seed sends the same work in another
order, and no input repeats within a cycle.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

# seed streams of one run, apart from each other
_JOB_STREAM, _WARM_STREAM, _SAMPLE_STREAM, _TABLE_STREAM, _ORDER_STREAM = 1, 2, 3, 4, 5


class Table(NamedTuple):
    X_tr: np.ndarray
    y_tr: np.ndarray
    X_te: np.ndarray
    y_te: np.ndarray


def make_dataset(mix: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(X, y) of the mix's shape: class-conditional Gaussian clusters for the
    continuous features, class-correlated multinomials for the informative
    categorical ones, uniform noise columns for the rest."""
    rng = np.random.default_rng(int(mix["table_seed"]))
    N = int(mix["n_rows"])
    M = int(mix["n_cols"])
    n_classes = int(mix["n_classes"])
    n_cat = int(round(float(mix["frac_categorical"]) * M))
    n_info = max(1, int(round(float(mix["frac_informative"]) * M)))
    info_cols = rng.permutation(M)[:n_info]
    info = np.zeros(M, dtype=bool)
    info[info_cols] = True

    y = rng.integers(0, n_classes, N)
    X = np.empty((N, M), dtype=np.float32)
    class_means = rng.normal(0.0, 2.0, (n_classes, M))
    for j in range(M):
        if j < n_cat:
            k = int(rng.integers(2, 12))  # cardinality
            if info[j]:
                probs = rng.dirichlet(np.ones(k) * 0.6, n_classes)
                u = rng.random(N)
                cdf = probs.cumsum(axis=1)
                X[:, j] = (u[:, None] < cdf[y]).argmax(axis=1)
            else:
                X[:, j] = rng.integers(0, k, N)
        else:
            mu = class_means[y, j] if info[j] else 0.0
            X[:, j] = mu + rng.normal(0.0, float(mix["noise"]), N)
    return X, y


def make_table(mix: dict) -> Table:
    """The mix's table, split once into training and held-out test rows."""
    X, y = make_dataset(mix)
    rng = np.random.default_rng([int(mix["table_seed"]), _TABLE_STREAM])
    perm = rng.permutation(len(y))
    n_test = max(1, int(float(mix["test_frac"]) * len(y)))
    te, tr = perm[:n_test], perm[n_test:]
    return Table(X[tr], y[tr], X[te], y[te])


def pool_input(mix: dict, entry: int, n_rows: int) -> Tuple[np.ndarray, int]:
    """Pool entry ``entry``'s row permutation of the training table and its
    seed; ``entry = -1`` is the set-up's untimed job, outside the pool."""
    stream = _WARM_STREAM if entry < 0 else _JOB_STREAM
    rng = np.random.default_rng([int(mix["table_seed"]), stream, max(entry, 0)])
    perm = rng.permutation(n_rows)
    return perm, int(rng.integers(0, 2 ** 31 - 1))


def pool_entry(mix: dict, run_seed: int, job: int) -> int:
    """The pool entry that the run's job ``job`` sends."""
    P = int(mix["job_pool"])
    cycle, k = divmod(int(job), P)
    return int(np.random.default_rng([int(run_seed), _ORDER_STREAM, cycle]).permutation(P)[k])


def sample_jobs(mix: dict, run_seed: int, n_expected: int, k: int) -> set:
    """The jobs whose answers the run checks: ``k`` drawn from the seed among
    the first ``n_expected`` (the jobs the window is sure to finish) of the
    first cycle, so each sends another pool entry."""
    rng = np.random.default_rng([int(run_seed), _SAMPLE_STREAM])
    n = max(1, min(int(n_expected), int(mix["job_pool"])))
    return set(int(j) for j in rng.choice(n, size=min(k, n), replace=False))
