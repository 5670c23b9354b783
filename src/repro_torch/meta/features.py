"""Dataset meta-features for the experience store (DESIGN.md §17.2).

The port of the JAX package's ``meta/features.py``.  The k-NN slice of the
portfolio builder needs a cheap vector describing "what kind of dataset is
this?".  Everything here is derived from the already factorized
``CodedDataset``: shapes, the per-column code cardinalities, the
target-column class distribution, and the per-column entropy profile through
``measures.full_column_entropy``.  The vector is computed on the host from
one host copy of the codes (``measures.host_codes``: free for a dataset on
the CPU, one copy for one on a card), so it adds no device work and no
further host wait to a served job.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.measures import CodedDataset, full_column_entropy, host_codes

__all__ = ["META_FEATURE_NAMES", "meta_features"]

# one name per slot of the vector ``meta_features`` returns, in order
META_FEATURE_NAMES = (
    "log1p_rows",          # log1p(N)
    "log1p_cols",          # log1p(M) (feature columns, target excluded)
    "n_classes",           # target-column cardinality
    "class_skew",          # max class frequency (1/k balanced .. 1.0 degenerate)
    "class_entropy",       # Shannon entropy (log2) of the class distribution
    "col_entropy_mean",    # mean per-column code entropy (target excluded)
    "col_entropy_std",     # std of the per-column code entropies
    "log2_mean_bins",      # log2 of the mean per-column code cardinality
)


def meta_features(coded: CodedDataset) -> np.ndarray:
    """The ``(len(META_FEATURE_NAMES),)`` float32 meta-feature vector.

    Deterministic function of the factorized codes: two datasets with the
    same fingerprint always produce bit-identical vectors."""
    codes, n_bins = host_codes(coded)
    N, M = codes.shape
    t = int(coded.target_col)

    k = max(int(n_bins[t]), 1)
    counts = np.bincount(codes[:, t], minlength=k).astype(np.float64)
    p = counts / max(counts.sum(), 1.0)
    nz = p[p > 0.0]
    class_entropy = float(-(nz * np.log2(nz)).sum()) if nz.size else 0.0
    class_skew = float(p.max()) if p.size else 1.0

    h = full_column_entropy(torch.from_numpy(codes), coded.max_bins).numpy().astype(
        np.float64)                                       # (M,)
    feat = np.ones(M, dtype=bool)
    feat[t] = False
    hf = h[feat] if feat.any() else h
    bins_f = n_bins[feat].astype(np.float64) if feat.any() else \
        n_bins.astype(np.float64)

    return np.array([
        np.log1p(float(N)),
        np.log1p(float(feat.sum())),
        float(k),
        class_skew,
        class_entropy,
        float(hf.mean()),
        float(hf.std()),
        float(np.log2(max(bins_f.mean(), 1.0))),
    ], dtype=np.float32)
