"""Synthetic tabular dataset generation mirroring the paper's 10 datasets.

A numpy copy of the JAX package's ``data/tabular.py``: the same seeds give
the same arrays in both packages.

The paper uses Kaggle/UCI downloads (Table 2).  The repository needs no
download: it generates datasets with the *same shapes* and controllable signal:
class-conditional Gaussian clusters for continuous features, class-correlated
multinomials for categorical features, plus pure-noise distractor columns.
The benchmark harness treats these exactly like the paper treats its corpus.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["DatasetSpec", "PAPER_DATASETS", "make_dataset", "train_test_split"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    domain: str
    n_rows: int
    n_cols: int                  # feature columns (paper counts incl. target)
    n_classes: int = 2
    frac_categorical: float = 0.4
    frac_informative: float = 0.5
    noise: float = 1.0
    seed: int = 0


# Table 2 of the paper (col counts there include the target column).
PAPER_DATASETS: Dict[str, DatasetSpec] = {
    "D1": DatasetSpec("D1", "flight service review", 129880, 22, 2, seed=1),
    "D2": DatasetSpec("D2", "signal processing", 15300, 4, 3, seed=2),
    "D3": DatasetSpec("D3", "car insurance", 10000, 17, 2, seed=3),
    "D4": DatasetSpec("D4", "mushroom classification", 8124, 22, 2,
                      frac_categorical=1.0, seed=4),
    "D5": DatasetSpec("D5", "air quality", 57660, 6, 4, seed=5),
    "D6": DatasetSpec("D6", "bike demand", 17415, 8, 3, seed=6),
    "D7": DatasetSpec("D7", "lead generation form", 46608, 14, 2, seed=7),
    "D8": DatasetSpec("D8", "myocardial infarction", 1700, 122, 2,
                      frac_informative=0.25, seed=8),
    "D9": DatasetSpec("D9", "heart disease", 79540, 6, 2, seed=9),
    "D10": DatasetSpec("D10", "poker matches", 1000000, 14, 4,
                       frac_categorical=0.8, seed=10),
}


def make_dataset(spec: DatasetSpec, scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Generate (X, y).  ``scale`` shrinks row count (CPU-friendly benches)."""
    rng = np.random.default_rng(spec.seed)
    N = max(64, int(spec.n_rows * scale))
    M = spec.n_cols
    n_cat = int(round(spec.frac_categorical * M))
    n_info = max(1, int(round(spec.frac_informative * M)))
    info_cols = rng.permutation(M)[:n_info]
    info = np.zeros(M, dtype=bool)
    info[info_cols] = True

    y = rng.integers(0, spec.n_classes, N)
    X = np.empty((N, M), dtype=np.float32)
    # per-class means for informative continuous features
    class_means = rng.normal(0.0, 2.0, (spec.n_classes, M))
    for j in range(M):
        if j < n_cat:
            k = int(rng.integers(2, 12))  # cardinality
            if info[j]:
                # class-correlated categorical: per-class multinomial
                probs = rng.dirichlet(np.ones(k) * 0.6, spec.n_classes)
                u = rng.random(N)
                cdf = probs.cumsum(axis=1)
                X[:, j] = (u[:, None] < cdf[y]).argmax(axis=1)
            else:
                X[:, j] = rng.integers(0, k, N)
        else:
            mu = class_means[y, j] if info[j] else 0.0
            X[:, j] = mu + rng.normal(0.0, spec.noise, N)
    return X, y


def train_test_split(X, y, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    N = len(y)
    perm = rng.permutation(N)
    n_test = max(1, int(test_frac * N))
    te, tr = perm[:n_test], perm[n_test:]
    return X[tr], y[tr], X[te], y[te]
