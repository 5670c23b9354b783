"""Plain PyTorch version of the masked histogram kernel, and the entropy of
a histogram.

The CPU path and, on the card, the oracle that
``tests/test_torch_kernels_card.py`` holds the CUDA kernel to.  Same
semantics as the JAX package's ``kernels/entropy/ref.py``.
"""
from __future__ import annotations

import torch

__all__ = ["masked_histogram_ref", "entropy_from_hist", "entropy_bits64"]


def masked_histogram_ref(codes: torch.Tensor, weights: torch.Tensor, bins: int) -> torch.Tensor:
    """hist[m, b] = sum_n w[n] * [codes[n, m] == b], via flat scatter-add."""
    N, M = codes.shape
    flat = (codes.long() + torch.arange(M, device=codes.device)[None, :] * bins).reshape(-1)
    w = weights.to(torch.float32)[:, None].expand(N, M).reshape(-1)
    out = torch.zeros(M * bins, dtype=torch.float32, device=codes.device)
    return out.scatter_add_(0, flat, w).reshape(M, bins)


def entropy_bits64(hist: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (log2) over the last axis, as float64.

    The reference's clamps (1e-12 on the total, 1e-30 inside the log), with
    the sums taken in float64: a float32 sum of ~256 terms near 8 bits is
    only good to ~1e-6, and how far off depends on the summation order.  In
    float64 every implementation (this one, the fused CUDA kernel) agrees to
    the final float32 rounding."""
    c = hist.to(torch.float64)
    p = c / c.sum(-1, keepdim=True).clamp_min(1e-12)
    return -torch.where(p > 0, p * torch.log2(p.clamp_min(1e-30)), 0.0).sum(-1)


def entropy_from_hist(hist: torch.Tensor) -> torch.Tensor:
    """Per-row entropy (float32) of (..., B) histograms."""
    return entropy_bits64(hist).to(torch.float32)
