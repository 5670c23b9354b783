"""CUDA wrapper of the masked histogram kernel (``csrc/masked_histogram.cu``).

Replaces the JAX package's Pallas kernel ``masked_histogram_pallas``
(``src/repro/kernels/entropy/kernel.py:45``).  The source states the design
and the bound.

Tolerance against ``ref.masked_histogram_ref``: with 0/1 weights the counts
are bit-exact (integer sums below 2^24 in any order).  With fractional
weights the shared-memory atomics add in another order than the plain
scatter, so each bin may differ by float32 rounding of its sum: within
``rtol = atol = 1e-5`` for weights in [0, 1) and N up to a few thousand.

``launches`` counts the kernel's launches; it is incremented only where the
kernel is launched.
"""
from __future__ import annotations

import torch

from .. import _build

__all__ = ["masked_histogram_cuda", "launches"]

launches = 0
_SMEM_BYTES = 48 * 1024


def tile_m_for(bins: int) -> int:
    """Columns per block: up to 8, as many as fit 48 KB of shared counts."""
    tile = min(8, _SMEM_BYTES // (4 * bins))
    if tile < 1:
        raise ValueError(f"masked_histogram_cuda: bins={bins} does not fit shared memory")
    return tile


def masked_histogram_cuda(codes: torch.Tensor, weights: torch.Tensor, bins: int) -> torch.Tensor:
    """(M, bins) f32 histogram of (N, M) int32 codes weighted by (N,) f32."""
    global launches
    if not (codes.is_cuda and weights.is_cuda and codes.device == weights.device):
        raise ValueError("masked_histogram_cuda: tensors must be on one CUDA device")
    if codes.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError("masked_histogram_cuda: codes must be int32 and weights float32")
    if codes.dim() != 2 or weights.shape != (codes.shape[0],):
        raise ValueError(f"masked_histogram_cuda: bad shapes {tuple(codes.shape)}, "
                         f"{tuple(weights.shape)}")
    if not (codes.is_contiguous() and weights.is_contiguous()):
        raise ValueError("masked_histogram_cuda: tensors must be contiguous")
    N, M = codes.shape
    out = torch.empty((M, bins), dtype=torch.float32, device=codes.device)
    if M == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = lib.launch_masked_histogram(codes.data_ptr(), weights.data_ptr(), out.data_ptr(),
                                      N, M, bins, tile_m_for(bins), stream)
    _build.check(err, "masked_histogram")
    launches += 1
    return out
