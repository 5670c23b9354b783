"""CUDA wrapper of the SSD-scan kernel (``csrc/ssd_scan.cu``).

Replaces the JAX package's Pallas kernel ``ssd_scan_pallas``
(``src/repro/kernels/ssd_scan/kernel.py:62``).  The source states the design
and the bound.  Unlike the TPU kernel it reads the model layout in place
(x (B, S, H, P), B/C (B, S, G, N), through their batch and position strides),
takes a partial last chunk, and also returns the final state.

Tolerance against ``ref.ssd_scan_model_ref`` (the per-timestep recurrence)
run in float32 on the same values: the chunked form sums in another order,
all in float32, so y agrees within 1e-3 in float32 and, after the one
rounding of bfloat16 outputs, within 5e-2 (``tests/test_ssd_kernel.py:35``
holds the Pallas kernel so); the final state within 1e-3 relative.

``launches`` counts the kernel's launches; it is incremented only where the
kernel is launched.
"""
from __future__ import annotations

import torch

from .. import _build

__all__ = ["ssd_scan_cuda", "chunk_for", "launches"]

launches = 0
_SMEM_LIMIT = 227 * 1024        # dynamic shared memory a Hopper block may use
_TI = 32                        # rows of the decay-weighted tile (csrc/ssd_scan.cu)
MAX_CHUNK = 64                  # the fastest chunk at zamba2's shape on the H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _smem_bytes(Q: int, P: int, N: int) -> int:
    return 4 * (2 * Q * (N + 1) + Q * (P + 1) + P * (N + 1) + _TI * (Q + 1) + 4 * Q)


def chunk_for(block_q: int, S: int, P: int, N: int) -> int:
    """The chunk the kernel walks: ``min(block_q, S, 64)``, halved until its
    tiles fit shared memory.  The chunk length changes only the summation
    order; 64 halves the quadratic work of 128 and lets three blocks share
    an SM."""
    Q = max(1, min(block_q, S, MAX_CHUNK))
    while Q > 1 and _smem_bytes(Q, P, N) > _SMEM_LIMIT:
        Q //= 2
    if _smem_bytes(Q, P, N) > _SMEM_LIMIT:
        raise ValueError(f"ssd_scan_cuda: P={P}, N={N} do not fit shared memory")
    return Q


def _inner_contiguous(t: torch.Tensor) -> bool:
    return t.stride(3) == 1 and t.stride(2) == t.shape[3]


def ssd_scan_cuda(x, dt, a, bm, cm, *, block_q: int = 128):
    """Model layout: x (B, S, H, P), dt (B, S, H) float32, a (H,) float32,
    bm/cm (B, S, G, N) in x's dtype (float32 or bfloat16) -> y (B, S, H, P)
    in x's dtype and the final state (B, H, P, N) float32.

    x, bm and cm may be views with any batch and position strides (bm and cm
    with the same strides) as long as their (heads, width) dims are
    contiguous; dt and a must be contiguous.  S need not be a multiple of
    the chunk."""
    global launches
    if not all(t.is_cuda and t.device == x.device for t in (x, dt, a, bm, cm)):
        raise ValueError("ssd_scan_cuda: tensors must be on one CUDA device")
    if x.dtype not in _DTYPES or bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan_cuda: x, bm, cm must share a dtype in {list(_DTYPES)}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("ssd_scan_cuda: dt and a must be float32")
    if x.dim() != 4 or bm.dim() != 4:
        raise ValueError(f"ssd_scan_cuda: bad shapes {tuple(x.shape)}, {tuple(bm.shape)}")
    B, S, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    if (dt.shape != (B, S, H) or a.shape != (H,) or bm.shape[:2] != (B, S)
            or cm.shape != bm.shape or G == 0 or H % G != 0):
        raise ValueError(f"ssd_scan_cuda: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, bm {tuple(bm.shape)}, cm {tuple(cm.shape)} "
                         f"do not fit (H must be a multiple of G)")
    if not (_inner_contiguous(x) and _inner_contiguous(bm) and cm.stride() == bm.stride()
            and dt.is_contiguous() and a.is_contiguous()):
        raise ValueError("ssd_scan_cuda: x, bm, cm need contiguous (heads, width) dims "
                         "and bm, cm equal strides; dt and a must be contiguous")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if B * S * H == 0:
        return y, h.zero_()
    Q = chunk_for(block_q, S, P, N)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.launch_ssd_scan(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
                              cm.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, H, G, P, N, Q,
                              x.stride(0), x.stride(1), bm.stride(0), bm.stride(1),
                              _DTYPES[x.dtype], stream)
    _build.check(err, "ssd_scan")
    launches += 1
    return y, h
