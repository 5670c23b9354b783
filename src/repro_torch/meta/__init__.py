"""Cross-tenant meta-learning (DESIGN.md §17): portfolio warm-starts.

The port of the JAX package's ``meta/``.

Every served job leaves behind training data for the next one — the
(dataset fingerprint × trial spec → rung accuracies) performance matrix the
scheduler's rung records accumulate.  This package turns that history into
rung-0 seed trials, PoSH-style (AAD Freiburg's PoSH Auto-sklearn is the
exemplar):

- ``store``     — the per-server :class:`ExperienceStore`: per-fingerprint
                  rung accuracies, winner specs, and meta-feature vectors,
                  with a bit-identical ``state_dict``/``load_state``.
- ``features``  — dataset meta-features from the already-factorized
                  ``CodedDataset`` (n, d, class skew, entropy profile), no
                  new passes over the raw data.
- ``portfolio`` — the deterministic greedy submodular portfolio builder
                  (maximize covered-dataset best accuracy) and the k-NN
                  meta-feature slice that picks which history a new job
                  warm-starts from.
"""
from .features import META_FEATURE_NAMES, meta_features
from .portfolio import (
    greedy_portfolio, knn_fingerprints, portfolio_coverage, portfolio_for,
    spec_sort_key,
)
from .store import ExperienceRecord, ExperienceStore

__all__ = [
    "ExperienceRecord", "ExperienceStore",
    "META_FEATURE_NAMES", "meta_features",
    "greedy_portfolio", "knn_fingerprints", "portfolio_coverage",
    "portfolio_for", "spec_sort_key",
]
