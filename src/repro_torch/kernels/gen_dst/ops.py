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
``(islands, phi, ...)``); they are flattened to one candidate axis for the
call and restored on return, as in the JAX package's ``gen_dst/ops.py:60-76``.
"""
from __future__ import annotations

import torch

from .kernel import fused_delta_fitness_cuda
from .ref import fused_delta_fitness_ref

__all__ = ["fused_delta_fitness"]


def fused_delta_fitness(counts, old_codes, new_codes, applied, col_mask, f_ref):
    """``(counts', fitness)`` for one fused Gen-DST generation update.

    ``counts'[p]`` is ``counts[p]`` with row ``old -> new`` swapped where
    ``applied[p]``; ``fitness[p] = -|F(d_p) - F(D)|`` from the updated
    counts under ``col_mask[p]``.  ``counts`` must be contiguous: it is
    updated in place through a flattened view."""
    if not counts.is_contiguous():
        raise ValueError("fused_delta_fitness: counts must be contiguous (updated in place)")
    lead = old_codes.shape[:-1]
    M, B = counts.shape[-2:]
    cf = counts.view(-1, M, B)
    of = old_codes.reshape(-1, M)
    nf = new_codes.reshape(-1, M)
    af = applied.reshape(-1)
    mf = col_mask.reshape(-1, M)
    f_ref = torch.as_tensor(f_ref, dtype=torch.float32, device=counts.device).reshape(1)
    if counts.is_cuda:
        _, fit = fused_delta_fitness_cuda(cf, of.contiguous(), nf.contiguous(), af,
                                          mf.to(torch.bool).contiguous(), f_ref)
    else:
        _, fit = fused_delta_fitness_ref(cf, of, nf, af, mf, f_ref)
    return counts, fit.reshape(lead)
