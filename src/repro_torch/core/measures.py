"""Dataset measures for measure-preserving data subsets (SubStrat §3.1).

The port of the JAX package's ``core/measures.py``; its module docstring is
the one statement of the layout conventions (``codes`` (N, M) int32,
``n_bins`` (M,), histogram width ``B``, padding bins exactly zero), and this
module keeps them.  ``factorize`` runs the same numpy code, so its codes,
``n_bins``, ``max_bins`` and ``target_col`` are bit-identical to the
reference's.

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

    Records two spans (``obs/trace``): ``factorize.host``, the per-column
    NumPy loop, and ``factorize.copy``, the three copies to ``device``."""
    dev = resolve_device(device)
    with _trace.span(None, None, "factorize.host"):
        X = np.asarray(X)
        cols = [np.asarray(X[:, j]) for j in range(X.shape[1])]
        if y is not None:
            cols.append(np.asarray(y))
        N = X.shape[0]
        codes = np.empty((N, len(cols)), dtype=np.int32)
        n_bins = np.empty((len(cols),), dtype=np.int32)
        values = np.empty((N, len(cols)), dtype=np.float32)
        for j, col in enumerate(cols):
            colf = col.astype(np.float64)
            values[:, j] = colf.astype(np.float32)
            uniq, inv = np.unique(colf, return_inverse=True)
            if len(uniq) <= max(categorical_threshold, 2) or (
                y is not None and j == len(cols) - 1
            ):
                codes[:, j] = inv.astype(np.int32)
                n_bins[j] = len(uniq)
            else:
                # quantile binning to at most max_bins codes
                qs = np.quantile(colf, np.linspace(0.0, 1.0, max_bins + 1)[1:-1])
                binned = np.searchsorted(qs, colf, side="right")
                # re-densify (some quantile bins may be empty)
                uniq_b, inv_b = np.unique(binned, return_inverse=True)
                codes[:, j] = inv_b.astype(np.int32)
                n_bins[j] = len(uniq_b)
        B = int(max(int(n_bins.max()), 2))
    with _trace.span(None, None, "factorize.copy"):
        return CodedDataset(
            codes=torch.from_numpy(codes).to(dev),
            values=torch.from_numpy(values).to(dev),
            n_bins=torch.from_numpy(n_bins).to(dev),
            target_col=len(cols) - 1 if y is not None else X.shape[1] - 1,
            max_bins=B,
        )


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
