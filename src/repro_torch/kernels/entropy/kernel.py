"""CUDA wrappers of the masked histogram kernel (``csrc/masked_histogram.cu``).

Replaces the JAX package's Pallas kernel ``masked_histogram_pallas``
(``src/repro/kernels/entropy/kernel.py:45``).  The source states the design
and the bound.  Two entries launch the same kernel:

* ``masked_histogram_cuda(codes, weights, bins)``: the TPU kernel's function,
  an (M, bins) histogram of (N, M) codes;
* ``population_histogram_rows_cuda(codes, rows, bins)``: the per-candidate
  histograms of ``codes[rows]`` with uniform weights, the row gather done
  inside the kernel (what ``population_histogram(codes[rows], bins)``
  computes with a gather, a transpose copy and the histogram).

Tolerance against the plain versions: with 0/1 weights the counts are
bit-exact (integer sums below 2^24 in any order).  With fractional weights
the shared-memory atomics add in another order than the plain scatter, so
each bin may differ by float32 rounding of its sum: within ``rtol = atol =
1e-5`` for weights in [0, 1) and N up to a few thousand.

``launches`` counts the kernel's launches through either entry; it is
incremented only where the kernel is launched.  The checks that raise on a
wrong input are kept cheap (dtypes compared at once, device indices as
ints), since at the main path's sizes the host's time per call is of the
order of the kernel's.
"""
from __future__ import annotations

import functools

import torch

from .. import _build

__all__ = ["masked_histogram_cuda", "population_histogram_rows_cuda", "launches", "tile_for"]

launches = 0
# fold columns per block, the fastest measured (PERF.md, section 6): integer counts
# (uniform weights) and float sums (weights), whose rows the kernel pads to an
# odd stride
TILE = {False: 8, True: 16}
_SMEM_BYTES = 48 * 1024          # default per-block shared memory
_SMEM_LIMIT = 232448             # with the opt-in (227 KB)


@functools.lru_cache(maxsize=64)
def tile_for(bins: int, weighted: bool) -> int:
    """Fold columns per block: ``TILE[weighted]``, halved until the tile's
    32-bit counts (rows of ``bins``, ``bins | 1`` with weights) fit 48 KB;
    one column with the opt-in up to 227 KB."""
    row = 4 * ((bins | 1) if weighted else bins)
    tile = TILE[weighted]
    while tile > 1 and tile * row > _SMEM_BYTES:
        tile //= 2
    if tile * row > _SMEM_LIMIT:
        raise ValueError(f"masked_histogram: bins={bins} does not fit shared memory")
    return tile


def _launch(codes, weights_ptr, rows_ptr, out, N, M, bins, P, R, dev) -> None:
    global launches
    err = _build.library().launch_masked_histogram(
        codes.data_ptr(), weights_ptr, rows_ptr, out.data_ptr(), N, M, bins, P, R,
        tile_for(bins, weights_ptr is not None), _build.stream(dev))
    _build.check(err, "masked_histogram")
    launches += 1


def masked_histogram_cuda(codes: torch.Tensor, weights: torch.Tensor, bins: int) -> torch.Tensor:
    """(M, bins) f32 histogram of (N, M) int32 codes weighted by (N,) f32."""
    dev = codes.get_device()
    if dev < 0 or weights.get_device() != dev:
        raise ValueError("masked_histogram_cuda: tensors must be on one CUDA device")
    if codes.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError("masked_histogram_cuda: codes must be int32 and weights float32")
    if codes.dim() != 2 or weights.shape != codes.shape[:1]:
        raise ValueError(f"masked_histogram_cuda: bad shapes {tuple(codes.shape)}, "
                         f"{tuple(weights.shape)}")
    if not (codes.is_contiguous() and weights.is_contiguous()):
        raise ValueError("masked_histogram_cuda: tensors must be contiguous")
    N, M = codes.shape
    out = codes.new_empty((M, bins), dtype=torch.float32)
    if M > 0:
        _launch(codes, weights.data_ptr(), None, out, N, M, bins, 1, N, dev)
    return out


def population_histogram_rows_cuda(codes: torch.Tensor, rows: torch.Tensor,
                                   bins: int) -> torch.Tensor:
    """(P, M, bins) f32: out[p, m, b] = |{i : codes[rows[p, i], m] == b}| for
    (N, M) int32 codes and (P, n) int32 row indices in [0, N).  The indices
    are not checked on the host, which would wait for the device: one
    outside [0, N) traps in the kernel, an error at the next synchronise
    that leaves the CUDA context unusable (as a device-side assert does)."""
    dev = codes.get_device()
    if dev < 0 or rows.get_device() != dev:
        raise ValueError("population_histogram_rows_cuda: tensors must be on one CUDA device")
    if codes.dtype != torch.int32 or rows.dtype != torch.int32:
        raise TypeError("population_histogram_rows_cuda: codes and rows must be int32")
    if codes.dim() != 2 or rows.dim() != 2:
        raise ValueError(f"population_histogram_rows_cuda: bad shapes {tuple(codes.shape)}, "
                         f"{tuple(rows.shape)}")
    if not (codes.is_contiguous() and rows.is_contiguous()):
        raise ValueError("population_histogram_rows_cuda: tensors must be contiguous")
    N, M = codes.shape
    P, n = rows.shape
    out = codes.new_empty((P, M, bins), dtype=torch.float32)
    if P > 0 and M > 0:
        _launch(codes, None, rows.data_ptr(), out, N, M, bins, P, n, dev)
    return out
