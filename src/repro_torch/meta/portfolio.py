"""Deterministic greedy submodular portfolio builder (DESIGN.md §17.3).

PoSH-style (SNIPPETS.md Snippet 1): given the experience store's
performance matrix, greedily pick the ``k`` trial specs maximizing the
*covered-dataset best accuracy*

    F(P) = sum over datasets d of max(0, max_{s in P} acc[s][d])

— a monotone submodular set function, so greedy is within (1 - 1/e) of the
optimal portfolio.  A new job does not score against the whole history: the
k-NN slice in meta-feature space picks the most similar stored datasets
first, and the portfolio is built over that slice.

Every choice point is deterministic and independent of history insertion
order: candidate specs are visited in ``spec_sort_key`` order, datasets in
sorted-fingerprint order, and k-NN ties break toward the lexically smaller
fingerprint — permuting the order jobs were served in never changes the
seeds a new job receives (property-tested in tests/test_meta.py).

A copy of the JAX package's ``meta/portfolio.py`` on the port's
``PipelineSpec``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..automl.engine import PipelineSpec
from .store import ExperienceStore

__all__ = ["spec_sort_key", "greedy_portfolio", "portfolio_coverage",
           "knn_fingerprints", "portfolio_for"]


def spec_sort_key(spec: PipelineSpec) -> tuple:
    """Total deterministic order over pipeline specs (tie-break order).

    ``hp`` values mix ints/floats/strings across families, so the hp leg
    compares by ``repr`` — stable, total, and value-faithful."""
    return (spec.family, spec.preproc, float(spec.feature_frac),
            repr(spec.hp))


def _covered(matrix: Dict[PipelineSpec, Dict[str, float]],
             chosen: Sequence[PipelineSpec], fps: Sequence[str],
             ) -> Dict[str, float]:
    best = {fp: 0.0 for fp in fps}
    for spec in chosen:
        for fp, acc in matrix.get(spec, {}).items():
            if fp in best and acc > best[fp]:
                best[fp] = acc
    return best


def portfolio_coverage(matrix: Dict[PipelineSpec, Dict[str, float]],
                       chosen: Sequence[PipelineSpec]) -> float:
    """F(chosen): summed covered best accuracy over the matrix's datasets."""
    fps = sorted({fp for accs in matrix.values() for fp in accs})
    return float(sum(_covered(matrix, chosen, fps).values()))


def greedy_portfolio(matrix: Dict[PipelineSpec, Dict[str, float]],
                     k: int) -> List[PipelineSpec]:
    """Greedy max-coverage portfolio of (up to) ``k`` specs.

    Each round adds the spec with the largest marginal coverage gain;
    ties — including the zero-gain tail once the matrix is covered — break
    toward the ``spec_sort_key``-smaller spec, so the result is a pure
    function of the matrix *contents*.  Always returns
    ``min(k, len(matrix))`` specs: zero-gain picks still seed useful rung-0
    trials (they were strong somewhere in history)."""
    specs = sorted(matrix, key=spec_sort_key)
    fps = sorted({fp for accs in matrix.values() for fp in accs})
    best = {fp: 0.0 for fp in fps}
    chosen: List[PipelineSpec] = []
    remaining = list(specs)
    for _ in range(min(max(k, 0), len(specs))):
        gains = []
        for s in remaining:
            gain = sum(max(acc - best[fp], 0.0)
                       for fp, acc in matrix[s].items() if fp in best)
            gains.append(gain)
        gi = int(np.argmax(gains))       # first max: sort-order tie-break
        pick = remaining.pop(gi)
        chosen.append(pick)
        for fp, acc in matrix[pick].items():
            if fp in best and acc > best[fp]:
                best[fp] = acc
    return chosen


def knn_fingerprints(features_by_fp: Dict[str, np.ndarray],
                     query: np.ndarray, k: int) -> List[str]:
    """The ``k`` stored fingerprints nearest ``query`` in meta-feature
    space (Euclidean; distance ties break toward the smaller fingerprint)."""
    q = np.asarray(query, dtype=np.float64)
    scored = sorted(
        (float(np.linalg.norm(np.asarray(f, dtype=np.float64) - q)), fp)
        for fp, f in features_by_fp.items())
    return [fp for _dist, fp in scored[:max(k, 0)]]


def portfolio_for(store: ExperienceStore,
                  features: Optional[np.ndarray], *,
                  k: int, knn: int,
                  exclude: Iterable[str] = ()) -> List[PipelineSpec]:
    """The rung-0 seed portfolio for a new dataset.

    Slices the store to the ``knn`` nearest trained fingerprints (all of
    them when ``features`` is None or ``knn`` covers the history), then
    builds the greedy portfolio over that slice.  Empty when the store has
    no usable history."""
    trained = store.trained(exclude)
    if not trained:
        return []
    if features is not None and 0 < knn < len(trained):
        feats = {fp: store.records[fp].features for fp in trained}
        trained = knn_fingerprints(feats, features, knn)
    return greedy_portfolio(store.matrix(trained), k)
