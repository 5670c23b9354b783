"""CUDA wrapper of the fused Gen-DST kernel (``csrc/fused_delta_fitness.cu``).

Replaces the JAX package's Pallas kernel ``fused_delta_fitness_pallas``
(``src/repro/kernels/gen_dst/kernel.py:77``).  The source states the design
and the bound.

The counts tensor is updated in place where the TPU kernel aliased its
output onto its input.  Against ``ref.fused_delta_fitness_ref`` the counts
are bit-equal (the same two adds per bin).  Both accumulate the entropy and
the masked mean in float64 and round the fitness to float32 once, so the
fitness agrees to float32 rounding: within 1e-6 absolute.

``launches`` counts the kernel's launches; it is incremented only where the
kernel is launched.
"""
from __future__ import annotations

import torch

from .. import _build

__all__ = ["fused_delta_fitness_cuda", "launches"]

launches = 0
_SMEM_BYTES = 48 * 1024


def fused_delta_fitness_cuda(counts, old_codes, new_codes, applied, col_mask, f_ref):
    """In-place delta + fitness over (P, M, B) f32 ``counts``.

    ``old_codes``/``new_codes`` (P, M) int32, ``applied`` (P,) any dtype
    (cast to f32 here), ``col_mask`` (P, M) bool, ``f_ref`` a one-element
    f32 tensor on the device.  Returns ``(counts, fitness)``."""
    global launches
    tensors = (counts, old_codes, new_codes, applied, col_mask, f_ref)
    if not all(t.is_cuda and t.device == counts.device for t in tensors):
        raise ValueError("fused_delta_fitness_cuda: tensors must be on one CUDA device")
    if counts.dtype != torch.float32 or f_ref.dtype != torch.float32:
        raise TypeError("fused_delta_fitness_cuda: counts and f_ref must be float32")
    if old_codes.dtype != torch.int32 or new_codes.dtype != torch.int32:
        raise TypeError("fused_delta_fitness_cuda: codes must be int32")
    if col_mask.dtype != torch.bool:
        raise TypeError("fused_delta_fitness_cuda: col_mask must be bool")
    if counts.dim() != 3:
        raise ValueError(f"fused_delta_fitness_cuda: counts must be (P, M, B), "
                         f"got {tuple(counts.shape)}")
    P, M, B = counts.shape
    if (old_codes.shape != (P, M) or new_codes.shape != (P, M)
            or col_mask.shape != (P, M) or applied.shape != (P,) or f_ref.numel() != 1):
        raise ValueError("fused_delta_fitness_cuda: inputs do not match counts' (P, M)")
    if M * 8 > _SMEM_BYTES:
        raise ValueError(f"fused_delta_fitness_cuda: M={M} does not fit shared memory")
    applied = applied.to(torch.float32).contiguous()
    if not all(t.is_contiguous() for t in (counts, old_codes, new_codes, col_mask, f_ref)):
        raise ValueError("fused_delta_fitness_cuda: tensors must be contiguous")
    fit = torch.empty(P, dtype=torch.float32, device=counts.device)
    if P == 0:
        return counts, fit
    lib = _build.library()
    stream = torch.cuda.current_stream(counts.device).cuda_stream
    err = lib.launch_fused_delta_fitness(
        counts.data_ptr(), old_codes.data_ptr(), new_codes.data_ptr(), applied.data_ptr(),
        col_mask.data_ptr(), f_ref.data_ptr(), fit.data_ptr(), P, M, B, stream)
    _build.check(err, "fused_delta_fitness")
    launches += 1
    return counts, fit
