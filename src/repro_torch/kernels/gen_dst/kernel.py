"""CUDA wrapper of the fused Gen-DST kernel (``csrc/fused_delta_fitness.cu``).

Replaces the JAX package's Pallas kernel ``fused_delta_fitness_pallas``
(``src/repro/kernels/gen_dst/kernel.py:77``).  The source states the design
and the bound.

The counts tensor is updated in place where the TPU kernel aliased its
output onto its input.  Against ``ref.fused_delta_fitness_ref`` the counts
are bit-equal (the same two adds per bin).  Both accumulate the entropy and
the masked mean in float64 and round the fitness to float32 once, so the
fitness agrees to float32 rounding: within 1e-6 absolute.

The wrapper takes the inputs with any leading shape (Gen-DST passes
``(islands, phi, ...)``) and reads them as one candidate axis through their
data pointers, so a call makes no views and no copies: at the main path's
size the host's time per call is of the order of the kernel's.  The checks
that raise on a wrong input stay, written to be cheap.

``launches`` counts the kernel's launches; it is incremented only where the
kernel is launched.
"""
from __future__ import annotations

import torch

from .. import _build

__all__ = ["fused_delta_fitness_cuda", "launches"]

launches = 0
_DTYPES = (torch.float32, torch.int32, torch.int32, torch.float32, torch.bool, torch.float32)


def fused_delta_fitness_cuda(counts, old_codes, new_codes, applied, col_mask, f_ref):
    """In-place delta + fitness over (..., M, B) f32 ``counts``.

    ``old_codes``/``new_codes`` (..., M) int32, ``applied`` (...,) f32,
    ``col_mask`` (..., M) bool, ``f_ref`` f32 on the device, one element or
    one per candidate (shape (...,)), all contiguous.  Returns
    ``(counts, fitness)``, fitness (...,)."""
    global launches
    dev = counts.get_device()
    if dev < 0 or not (old_codes.get_device() == new_codes.get_device() == applied.get_device()
                       == col_mask.get_device() == f_ref.get_device() == dev):
        raise ValueError("fused_delta_fitness_cuda: tensors must be on one CUDA device")
    if (counts.dtype, old_codes.dtype, new_codes.dtype, applied.dtype, col_mask.dtype,
            f_ref.dtype) != _DTYPES:
        raise TypeError("fused_delta_fitness_cuda: counts, applied and f_ref must be float32, "
                        "the codes int32 and col_mask bool")
    shape = counts.shape
    if len(shape) < 2:
        raise ValueError(f"fused_delta_fitness_cuda: counts must be (..., M, B), got {shape}")
    col_shape = shape[:-1]
    if (old_codes.shape != col_shape or new_codes.shape != col_shape
            or col_mask.shape != col_shape or applied.shape != col_shape[:-1]):
        raise ValueError("fused_delta_fitness_cuda: inputs do not match counts' (..., M)")
    # the kernel reads candidate p's F(D) at f_ref[p * step]
    if f_ref.numel() == 1:
        f_ref_step = 0
    elif f_ref.shape == applied.shape:
        f_ref_step = 1
    else:
        raise ValueError("fused_delta_fitness_cuda: f_ref must have one element or one per "
                         "candidate")
    if not (counts.is_contiguous() and old_codes.is_contiguous() and new_codes.is_contiguous()
            and applied.is_contiguous() and col_mask.is_contiguous()
            and f_ref.is_contiguous()):
        raise ValueError("fused_delta_fitness_cuda: tensors must be contiguous")
    M, B = shape[-2], shape[-1]
    fit = counts.new_empty(col_shape[:-1])      # new_empty: no device argument to parse
    P = fit.numel()
    if P == 0:
        return counts, fit
    err = _build.library().launch_fused_delta_fitness(
        counts.data_ptr(), old_codes.data_ptr(), new_codes.data_ptr(), applied.data_ptr(),
        col_mask.data_ptr(), f_ref.data_ptr(), fit.data_ptr(), P, M, B, f_ref_step,
        _build.stream(dev))
    _build.check(err, "fused_delta_fitness")
    launches += 1
    return counts, fit
