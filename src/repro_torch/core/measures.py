"""Dataset measures for measure-preserving data subsets (SubStrat §3.1).

The port of the JAX package's ``core/measures.py``; its module docstring is
the one statement of the layout conventions (``codes`` (N, M) int32,
``n_bins`` (M,), histogram width ``B``, padding bins exactly zero), and this
module keeps them.  ``factorize`` codes every column at once on the
table's device (one float64 sort, numpy's unique and linear-quantile
arithmetic reproduced step by step), so its codes, ``n_bins``, ``max_bins``
and ``target_col`` are bit-identical to the reference's per-column NumPy.

Codes and row indices are stored as int32 (the kernels take int32); they
are cast to int64 only where torch indexes or scatters with them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.entropy.ref import entropy_bits64
from ..obs import trace as _trace

__all__ = [
    "CodedDataset",
    "factorize",
    "host_codes",
    "column_counts",
    "column_entropy_from_counts",
    "column_entropy",
    "dataset_entropy",
    "subset_counts",
    "subset_entropy",
    "full_column_entropy",
    "measure_pnorm",
    "measure_mean_correlation",
    "measure_coeff_variation",
    "MEASURES",
]


class CodedDataset(NamedTuple):
    """A factorized dataset ready for entropy computation.

    ``values`` keeps the raw (float) matrix for measures other than entropy;
    ``codes`` drives the entropy measure.  Tensors live on one device."""

    codes: torch.Tensor       # (N, M) int32
    values: torch.Tensor      # (N, M) float32 (raw, un-normalized)
    n_bins: torch.Tensor      # (M,) int32
    target_col: int           # index of the target column (always in DSTs)
    max_bins: int             # histogram width B

    @property
    def num_rows(self) -> int:
        return self.codes.shape[0]

    @property
    def num_cols(self) -> int:
        return self.codes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def to(self, device) -> "CodedDataset":
        return self._replace(codes=self.codes.to(device), values=self.values.to(device),
                             n_bins=self.n_bins.to(device))


def _quantile_positions(N: int, max_bins: int):
    """Where ``np.quantile(col, np.linspace(0, 1, max_bins + 1)[1:-1])``
    (method "linear") reads a sorted column of ``N`` values: the lower and
    upper index and the weight of each edge.  They depend on ``N`` alone,
    so they are computed here in float64 exactly as numpy's ``_quantile``
    computes them (``_compute_virtual_index``, ``_get_indexes`` with its
    clipping, ``_get_gamma``: an index at or past the last reads it twice,
    with the weight taken from the clipped index)."""
    q = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]
    virtual = (N - 1) * q
    lo = np.floor(virtual)
    hi = lo + 1
    above = virtual >= N - 1
    lo[above] = -1
    hi[above] = -1
    lo, hi = lo.astype(np.intp), hi.astype(np.intp)
    gamma = np.asarray(virtual - lo, dtype=virtual.dtype)
    return lo % N, hi % N, gamma


def _lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """numpy's ``_lerp``, one rounded operation at a time (never a fused
    multiply-add): ``a + (b - a) * t``, and ``b - (b - a) * (1 - t)`` where
    ``t >= 0.5``."""
    d = b - a
    return torch.where(t >= 0.5, b - d * (1.0 - t), a + d * t)


# dtypes that copy to a card as they are; any other is cast to float64 first
_COPYABLE = {np.dtype(d) for d in ("float64", "float32", "float16", "int64", "int32",
                                   "int16", "int8", "uint8", "bool")}


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _COPYABLE:
        a = a.astype(np.float64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def factorize(
    X: np.ndarray,
    y: Optional[np.ndarray] = None,
    *,
    max_bins: int = 256,
    categorical_threshold: int = 64,
    device: DeviceLike = None,
) -> CodedDataset:
    """Factorize a raw matrix (optionally with a target column) to codes.

    Columns with <= ``categorical_threshold`` distinct values keep exact value
    identity (one code per distinct value).  Denser columns are quantile-
    binned to ``max_bins`` codes.  The target column ``y`` (if given) is
    appended as the last column and is always treated as categorical.

    All columns at once on ``device``, with the reference's per-column NumPy
    results bit for bit: one float64 sort of the (M, N) column matrix gives
    ``np.unique``'s inverse (ranks among the distinct values, NaNs one last
    value) and ``np.quantile``'s linear edges (``_quantile_positions``,
    ``_lerp``; a column holding a NaN has NaN edges, so its NaNs take the
    last bin and every other value the first).  A column holding +-inf can
    get NaN edges among finite ones, where numpy's binary search depends on
    the order of the values searched; such a binned column is not matched.

    Records three spans (``obs/trace``): ``factorize.host``, the edges'
    positions computed on the host from ``N``; ``factorize.copy``, the
    copies of ``X``, ``y`` and those positions to ``device``; and
    ``factorize.device``, the sort, the edges and the codes, up to the one
    read of ``n_bins`` that waits for them."""
    dev = resolve_device(device)
    with _trace.span(None, None, "factorize.host"):
        X = np.asarray(X)
        N, d = X.shape
        lo, hi, gamma = _quantile_positions(N, max_bins)
    with _trace.span(None, None, "factorize.copy"):
        # the table, and where the edges read the sorted columns
        Xd = _to_device(X, dev)
        yd = None if y is None else _to_device(y, dev)
        at = torch.from_numpy(np.stack([lo, hi, gamma])).to(dev)
    with _trace.span(None, None, "factorize.device"):
        M = d + (yd is not None)
        cols = torch.empty((M, N), dtype=torch.float64, device=dev)
        cols[:d] = Xd.T
        if yd is not None:
            cols[d] = yd.reshape(N)
        values = cols.T.to(torch.float32, memory_format=torch.contiguous_format)

        srt, order = torch.sort(cols, dim=1)
        nan = srt.isnan()
        # a new distinct value wherever the sorted value differs from the one
        # before it, by value (-0.0 == 0.0), NaNs counting as one value
        new = torch.ones_like(nan)
        new[:, 1:] = (srt[:, 1:] != srt[:, :-1]) & ~(nan[:, 1:] & nan[:, :-1])
        rank = torch.cumsum(new, dim=1) - 1
        distinct = rank[:, -1] + 1
        exact = torch.empty_like(order).scatter_(1, order, rank)

        lo, hi = at[:2].long()
        edges = _lerp(srt[:, lo], srt[:, hi], at[2])
        binned = torch.searchsorted(edges, cols, right=True)
        has_nan = nan[:, -1:]
        binned = torch.where(has_nan, torch.where(cols.isnan(), edges.shape[1], 0), binned)
        # re-densify: the rank of each bin among the column's occupied bins
        occupied = torch.zeros((M, max_bins), dtype=torch.int64, device=dev)
        occupied.scatter_(1, binned, 1)
        dense = torch.cumsum(occupied, dim=1) - 1
        occupied_n = dense[:, -1] + 1

        keep = distinct <= max(categorical_threshold, 2)
        if y is not None:
            keep[-1:].fill_(True)
        codes = torch.where(keep[:, None], exact, dense.gather(1, binned))
        codes = codes.T.to(torch.int32, memory_format=torch.contiguous_format)
        n_bins = torch.where(keep, distinct, occupied_n).to(torch.int32)
        B = max(int(n_bins.cpu().max()), 2)
    return CodedDataset(codes=codes, values=values, n_bins=n_bins,
                        target_col=M - 1 if y is not None else d - 1, max_bins=B)


def host_codes(coded: CodedDataset) -> tuple:
    """``(codes, n_bins)`` of ``coded`` as host int32 numpy arrays.

    Free for a dataset on the CPU (views of its tensors); for one on a card,
    one device-to-host copy of the two packed together."""
    codes, n_bins = coded.codes, coded.n_bins
    if codes.device.type == "cpu" and n_bins.device.type == "cpu":
        return (codes.to(torch.int32).numpy(), n_bins.to(torch.int32).numpy())
    N, M = codes.shape
    packed = torch.cat([codes.reshape(-1).to(torch.int32),
                        n_bins.to(codes.device, torch.int32)]).cpu().numpy()
    return packed[:N * M].reshape(N, M), packed[N * M:]


# ---------------------------------------------------------------------------
# Histogram + entropy primitives (plain torch; the CUDA kernel in
# kernels/entropy computes subset_counts' masked-histogram semantics).
# ---------------------------------------------------------------------------


def column_counts(codes: torch.Tensor, B: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-column histogram via flat ``scatter_add_``.

    codes: (n, M) int32;  weights: optional (n,) row weights.
    Returns (M, B) float32 counts."""
    n, M = codes.shape
    flat = (codes.long() + torch.arange(M, device=codes.device)[None, :] * B).reshape(-1)
    w = (torch.ones(n, dtype=torch.float32, device=codes.device) if weights is None
         else weights.to(torch.float32))
    w = w[:, None].expand(n, M).reshape(-1)
    counts = torch.zeros(M * B, dtype=torch.float32, device=codes.device)
    return counts.scatter_add_(0, flat, w).reshape(M, B)


def column_entropy_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (log2) per column from (..., M, B) counts, float32.
    Zero-safe, with the reference's clamps (1e-12 on the total, 1e-30 inside
    the log); summed in float64 (``entropy_bits64``), as the fused kernel is."""
    return entropy_bits64(counts).to(torch.float32)


def column_entropy(codes: torch.Tensor, B: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return column_entropy_from_counts(column_counts(codes, B, weights))


def _masked_mean_entropy(counts: torch.Tensor, col_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean column entropy over ``col_mask`` (all columns if None), in float64
    like the fused kernel's fitness, rounded to float32 once."""
    h = entropy_bits64(counts)
    if col_mask is None:
        return h.mean(-1).to(torch.float32)
    cm = col_mask.to(torch.float64)
    return ((h * cm).sum(-1) / cm.sum(-1).clamp_min(1.0)).to(torch.float32)


def dataset_entropy(
    codes: torch.Tensor,
    B: int,
    col_mask: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """H(D) (Def. 3.4): mean over (selected) columns of column entropy."""
    return _masked_mean_entropy(column_counts(codes, B, weights), col_mask)


def full_column_entropy(codes: torch.Tensor, B: int, chunk: int = 65536) -> torch.Tensor:
    """Column entropy of the full dataset, chunked over rows (bounded memory).

    Used once per Gen-DST run to compute the reference ``F(D)`` terms."""
    N, M = codes.shape
    counts = torch.zeros((M, B), dtype=torch.float32, device=codes.device)
    for lo in range(0, N, chunk):
        counts += column_counts(codes[lo:lo + chunk], B)
    return column_entropy_from_counts(counts)


def subset_counts(codes: torch.Tensor, row_idx: torch.Tensor, B: int) -> torch.Tensor:
    """Histogram of the rows indexed by ``row_idx`` (gather path).

    codes: (N, M); row_idx: (n,) int32. Returns (M, B) counts."""
    return column_counts(codes[row_idx.long()], B)


def subset_entropy(
    codes: torch.Tensor,
    row_idx: torch.Tensor,
    col_mask: torch.Tensor,
    B: int,
) -> torch.Tensor:
    """H(D[r, c]) for one candidate DST: rows by index, columns by mask."""
    return _masked_mean_entropy(subset_counts(codes, row_idx, B), col_mask)


# ---------------------------------------------------------------------------
# Alternative dataset measures (paper §3.1: p-norm, mean-correlation,
# coefficient of variation) on the raw float values of the subset.  Each
# takes ``row_idx`` with any leading batch shape (..., n) and ``col_mask``
# (..., M), and returns one value per leading index; ``row_idx=None`` scores
# the whole table and ``col_mask=None`` means every column.
# ---------------------------------------------------------------------------


def _subset_values(values, row_idx, col_mask):
    sub = values if row_idx is None else values[row_idx.long()]      # (..., n, M)
    cm = (torch.ones(values.shape[1], dtype=torch.float32, device=values.device)
          if col_mask is None else col_mask.to(torch.float32))
    return sub, cm


def _weighted(per_col: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
    return (per_col * cm).sum(-1) / cm.sum(-1).clamp_min(1.0)


def measure_pnorm(values, row_idx=None, col_mask=None, p: float = 2.0):
    """Mean per-column p-norm, normalized by row count (scale-comparable)."""
    sub, cm = _subset_values(values, row_idx, col_mask)
    n = sub.shape[-2]
    norms = ((sub.abs() ** p).sum(-2) / n) ** (1.0 / p)              # (..., M)
    return _weighted(norms, cm)


def measure_mean_correlation(values, row_idx=None, col_mask=None):
    """Mean absolute pairwise Pearson correlation among selected columns."""
    sub, cm = _subset_values(values, row_idx, col_mask)
    mu = sub.mean(-2, keepdim=True)
    sd = sub.std(-2, keepdim=True, correction=0) + 1e-9
    z = (sub - mu) / sd
    corr = (z.transpose(-1, -2) @ z) / sub.shape[-2]                 # (..., M, M)
    M = values.shape[1]
    w = cm[..., :, None] * cm[..., None, :]
    w = w * (1.0 - torch.eye(M, device=values.device))
    return (corr.abs() * w).sum((-1, -2)) / w.sum((-1, -2)).clamp_min(1.0)


def measure_coeff_variation(values, row_idx=None, col_mask=None):
    """Mean per-column coefficient of variation sigma/|mu|."""
    sub, cm = _subset_values(values, row_idx, col_mask)
    mu = sub.mean(-2)
    sd = sub.std(-2, correction=0)
    return _weighted(sd / (mu.abs() + 1e-9), cm)


# Registry contract: ``MEASURES[name]`` is a callable
# ``fn(values, row_idx=None, col_mask=None)`` scoring a (sub)dataset on raw
# float values, or ``None`` for "entropy", which Gen-DST routes through the
# histogram path (carried per-candidate counts and the kernels) instead.
MEASURES = {
    "entropy": None,
    "pnorm": measure_pnorm,
    "mean_correlation": measure_mean_correlation,
    "coeff_variation": measure_coeff_variation,
}
