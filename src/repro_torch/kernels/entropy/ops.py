"""Public ops for the masked histogram: the device picks the implementation.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), which launches
or raises; a CPU tensor goes to the plain version (``ref.py``).  There is no
fallback from one to the other.
"""
from __future__ import annotations

import torch

from .kernel import masked_histogram_cuda
from .ref import entropy_from_hist, masked_histogram_ref

__all__ = ["masked_histogram", "column_entropy_masked", "population_histogram"]


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
