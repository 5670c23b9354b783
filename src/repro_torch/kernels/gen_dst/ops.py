"""Public op for the fused Gen-DST generation step: the device picks the
implementation.

``fused_delta_fitness`` is the one primitive the Gen-DST loop calls per
generation: delta-update the per-candidate (M, B) count tensor after a
one-row mutation and reduce it to the masked-entropy fitness.  Recompute
generations pass ``applied = 0`` (zero delta), so the same call is also the
fitness reduction over fresh histograms.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), which launches
or raises; a CPU tensor goes to the plain version (``ref.py``).  Both update
``counts`` in place.  Inputs may carry any leading shape (Gen-DST calls with
``(islands, phi, ...)``), as in the JAX package's ``gen_dst/ops.py:60-76``:
the kernel reads them as one candidate axis through their data pointers, and
the plain version gets flattened views.
"""
from __future__ import annotations

import torch

from .kernel import fused_delta_fitness_cuda
from .ref import fused_delta_fitness_ref

__all__ = ["fused_delta_fitness"]


def fused_delta_fitness(counts, old_codes, new_codes, applied, col_mask, f_ref):
    """``(counts', fitness)`` for one fused Gen-DST generation update.

    ``counts'[p]`` is ``counts[p]`` with row ``old -> new`` swapped where
    ``applied[p]``; ``fitness[p] = -|F(d_p) - F(D_p)|`` from the updated
    counts under ``col_mask[p]``.  ``f_ref`` is one F(D) for every candidate,
    or one per candidate (the leading shape of ``applied``), as when several
    datasets' searches share a call.  ``counts`` must be contiguous: it is
    updated in place.  The other inputs are taken as the plain version takes
    them, strided or of another dtype for ``applied``, ``col_mask`` and
    ``f_ref``; on a card, inputs already contiguous and of the kernel's dtypes,
    as Gen-DST passes them, go to it unconverted."""
    if not counts.is_contiguous():
        raise ValueError("fused_delta_fitness: counts must be contiguous (updated in place)")
    if counts.is_cuda:
        if applied.dtype != torch.float32:
            applied = applied.to(torch.float32)
        if col_mask.dtype != torch.bool:
            col_mask = col_mask.to(torch.bool)
        if not (isinstance(f_ref, torch.Tensor) and f_ref.dtype == torch.float32
                and f_ref.get_device() == counts.get_device()):
            f_ref = torch.as_tensor(f_ref, dtype=torch.float32, device=counts.device)
        return fused_delta_fitness_cuda(counts, old_codes.contiguous(), new_codes.contiguous(),
                                        applied.contiguous(), col_mask.contiguous(),
                                        f_ref.contiguous())
    lead = old_codes.shape[:-1]
    M, B = counts.shape[-2:]
    f_ref = torch.as_tensor(f_ref, dtype=torch.float32, device=counts.device).reshape(-1)
    _, fit = fused_delta_fitness_ref(counts.view(-1, M, B), old_codes.reshape(-1, M),
                                     new_codes.reshape(-1, M), applied.reshape(-1),
                                     col_mask.reshape(-1, M), f_ref)
    return counts, fit.reshape(lead)
