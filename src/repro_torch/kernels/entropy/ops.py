"""Public ops for the masked histogram: the device picks the implementation.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), which launches
or raises; a CPU tensor goes to the plain version (``ref.py``).  There is no
fallback from one to the other.
"""
from __future__ import annotations

import torch

from .kernel import masked_histogram_cuda, population_histogram_rows_cuda
from .ref import entropy_from_hist, masked_histogram_ref

__all__ = ["masked_histogram", "column_entropy_masked", "population_histogram",
           "population_histogram_rows"]


def masked_histogram(codes: torch.Tensor, weights: torch.Tensor, bins: int) -> torch.Tensor:
    """(M, bins) histogram of (N, M) int32 codes weighted by (N,) weights."""
    if codes.is_cuda:
        return masked_histogram_cuda(codes, weights, bins)
    return masked_histogram_ref(codes, weights, bins)


def column_entropy_masked(codes: torch.Tensor, weights: torch.Tensor, bins: int) -> torch.Tensor:
    """(M,) per-column entropy of the weighted (membership-masked) rows."""
    return entropy_from_hist(masked_histogram(codes, weights, bins))


def population_histogram(sub_codes: torch.Tensor, bins: int) -> torch.Tensor:
    """Per-candidate histograms: out[p, m, b] = |{i : sub_codes[p, i, m] == b}|.

    The population folds into the column axis, (P, n, M) -> (n, P*M), so one
    launch covers every candidate (each candidate's columns are independent
    and the weights uniform), as in the JAX package's ``entropy/ops.py:83``."""
    P, n, M = sub_codes.shape
    flat = sub_codes.permute(1, 0, 2).reshape(n, P * M).contiguous()
    ones = torch.ones(n, dtype=torch.float32, device=sub_codes.device)
    return masked_histogram(flat, ones, bins).reshape(P, M, bins)


def population_histogram_rows(codes: torch.Tensor, rows: torch.Tensor, bins: int) -> torch.Tensor:
    """``population_histogram(codes[rows], bins)``: out[p, m, b] =
    |{i : codes[rows[p, i], m] == b}| for (N, M) codes and (P, n) row indices.

    On a card one kernel launch gathers the rows as it counts them; rows of
    another integer dtype are converted to int32 and strided inputs copied
    first, so the op takes what the plain version takes.  On the CPU it is
    exactly that composition, the plain version.  An index outside [0, N) is
    an error on both: the plain version raises IndexError, and the kernel
    traps, as PyTorch's own indexing of a CUDA tensor does with its
    device-side assert, so the error surfaces at the next synchronise and
    leaves the process's CUDA context unusable."""
    if codes.is_cuda:
        if rows.dtype != torch.int32:
            rows = rows.to(torch.int32)
        return population_histogram_rows_cuda(codes.contiguous(), rows.contiguous(), bins)
    return population_histogram(codes[rows.long()], bins)
