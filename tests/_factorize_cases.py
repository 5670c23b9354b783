"""Tables that ``factorize`` is held to NumPy on: ``CASES[name]()`` gives
``(X, y, kwargs)``.  The paper's D1 and D6 training tables at full size, and
small tables at the edges of the algorithm: the 64/65 distinct-value switch,
ties at the quantile edges, tiny and round row counts, +-0.0, NaN.  No JAX.
"""
import numpy as np


def _paper(name):
    from repro_torch.data.tabular import PAPER_DATASETS, make_dataset, train_test_split
    X, y, _, _ = train_test_split(*make_dataset(PAPER_DATASETS[name]))
    return X, y, {}


def _rng(seed):
    return np.random.default_rng(seed)


def _switch():
    """Exactly 64 distinct values (coded) and 65 (binned), a constant, a
    two-valued column and one of +-0.0 mixed."""
    rng, N = _rng(1), 1000
    c64 = rng.permutation(np.arange(N) % 64).astype(np.float32) * 0.37
    c65 = rng.permutation(np.arange(N) % 65).astype(np.float32) - 20.0
    zeros = np.where(rng.random(N) < 0.5, -0.0, 0.0)
    X = np.column_stack([c64, c65, np.full(N, 3.25), rng.integers(0, 2, N) * 7.0, zeros,
                         zeros + rng.normal(size=N) * (rng.random(N) < 0.3)])
    return X.astype(np.float32), rng.integers(0, 3, N), {}


def _ties():
    """Integer columns of > 64 distinct values whose ties span the quantile
    edges: blocks of one value, geometric counts, two huge blocks."""
    rng, N = _rng(2), 6000
    blocks = rng.permutation(np.repeat(np.arange(100), N // 100))
    geo = np.minimum(rng.geometric(0.05, N), 400)
    two = np.where(rng.random(N) < 0.45, 5, np.where(rng.random(N) < 0.8, 9, rng.integers(0, 90, N)))
    return np.column_stack([blocks, geo, two]).astype(np.float32), rng.integers(0, 2, N), {}


def _float64_no_target():
    rng, N = _rng(3), 2000
    X = np.column_stack([rng.normal(size=N) * 1e-9, rng.exponential(1e6, N),
                         rng.integers(0, 5, N) + 0.1, rng.uniform(-1, 1, N)])
    return X, None, {}


def _wide_target():
    """A target of 200 classes stays coded exactly."""
    rng, N = _rng(4), 3000
    return rng.normal(size=(N, 3)).astype(np.float32), rng.integers(0, 200, N), {}


def _rows(N):
    """N rows; threshold 2 bins every column of 3 or more distinct values."""
    def make():
        rng = _rng(100 + N)
        X = np.column_stack([rng.normal(size=N), rng.integers(0, 3, N), rng.integers(0, 70, N),
                             np.arange(N) % 7]).astype(np.float32)
        return X, rng.integers(0, 4, N), {"categorical_threshold": 2}
    return make


def _sweep():
    """Every N from 4 to 130 and a few beyond, each the first N rows of one
    draw, at thresholds 2 and 64: a list of tables."""
    rng = _rng(5)
    big = np.column_stack([rng.normal(size=600), rng.integers(0, 70, 600),
                           rng.exponential(1.0, 600)]).astype(np.float32)
    yb = rng.integers(0, 3, 600)
    return [(big[:N], yb[:N], {"categorical_threshold": thr})
            for N in list(range(4, 131)) + [199, 200, 511, 512, 513, 600]
            for thr in (2, 64)]


def _nan():
    """NaN in a coded column (one last code) and in a binned one (NaN edges:
    NaNs in the last bin, every other value in the first)."""
    rng, N = _rng(6), 1500
    coded = rng.integers(0, 5, N).astype(np.float32)
    binned = rng.normal(size=N).astype(np.float32)
    coded[rng.random(N) < 0.1] = np.nan
    binned[rng.random(N) < 0.05] = np.nan
    allnan = np.full(N, np.nan, np.float32)
    return np.column_stack([coded, binned, allnan, rng.normal(size=N)]), rng.integers(0, 3, N), {}


def _small_bins():
    rng, N = _rng(7), 900
    X = np.column_stack([rng.normal(size=N), rng.integers(0, 12, N), rng.integers(0, 6, N)])
    return X.astype(np.float32), rng.integers(0, 3, N), {"max_bins": 16,
                                                           "categorical_threshold": 8}


CASES = {
    "d1_train": lambda: _paper("D1"),
    "d6_train": lambda: _paper("D6"),
    "distinct_64_65": _switch,
    "ties_at_edges": _ties,
    "float64_no_target": _float64_no_target,
    "target_200_classes": _wide_target,
    **{f"rows_{N}": _rows(N) for N in (1, 2, 3, 255, 256, 257)},
    "rows_sweep": _sweep,
    "nan": _nan,
    "max_bins_16": _small_bins,
}


def tables(name):
    """The case's tables, as a list of ``(X, y, kwargs)``."""
    out = CASES[name]()
    return out if isinstance(out, list) else [out]


def numpy_factorize(X, y=None, max_bins=256, categorical_threshold=64):
    """The per-column NumPy loop (``np.unique``, ``np.quantile``,
    ``np.searchsorted``): ``(codes, n_bins, max_bins)``."""
    cols = [X[:, j] for j in range(X.shape[1])] + ([] if y is None else [y])
    codes = np.empty((X.shape[0], len(cols)), np.int32)
    n_bins = np.empty(len(cols), np.int32)
    for j, col in enumerate(cols):
        colf = np.asarray(col, np.float64)
        uniq, inv = np.unique(colf, return_inverse=True)
        if len(uniq) <= max(categorical_threshold, 2) or (y is not None and j == len(cols) - 1):
            codes[:, j], n_bins[j] = inv, len(uniq)
        else:
            qs = np.quantile(colf, np.linspace(0.0, 1.0, max_bins + 1)[1:-1])
            ub, ib = np.unique(np.searchsorted(qs, colf, side="right"), return_inverse=True)
            codes[:, j], n_bins[j] = ib, len(ub)
    return codes, n_bins, max(int(n_bins.max()), 2)
