"""Plain PyTorch version of the fused Gen-DST generation kernel.

The same two steps the kernel fuses, as in the JAX package's
``kernels/gen_dst/ref.py``: the row-delta scatter (``-w`` at the evicted
row's codes, then ``+w`` at the inserted row's) and the masked-entropy
fitness.  ``counts`` is updated in place, as the kernel does.  The entropy
and the masked mean are taken in float64 and the fitness rounded to float32
once, as the kernel does (``entropy_bits64``).
"""
from __future__ import annotations

import torch

from ..entropy.ref import entropy_bits64

__all__ = ["fused_delta_fitness_ref"]


def fused_delta_fitness_ref(counts, old_codes, new_codes, applied, col_mask, f_ref):
    """Delta-update ``counts`` (P, M, B) in place, then return
    ``(counts, fitness)`` with ``fitness[p] = -|F(d_p) - F(D_p)|``; ``f_ref``
    holds one F(D) for every candidate, or one per candidate (P,)."""
    P, M = old_codes.shape
    w = applied.to(torch.float32)[:, None].expand(P, M)
    ai = torch.arange(P, device=counts.device)[:, None].expand(P, M)
    aj = torch.arange(M, device=counts.device)[None, :].expand(P, M)
    counts.index_put_((ai, aj, old_codes.long()), -w, accumulate=True)
    counts.index_put_((ai, aj, new_codes.long()), w, accumulate=True)
    h = entropy_bits64(counts)                                 # (P, M) float64
    cm = col_mask.to(torch.float64)
    f_d = (h * cm).sum(-1) / cm.sum(-1).clamp_min(1.0)
    fit = -(f_d - torch.as_tensor(f_ref, device=counts.device).to(torch.float64)).abs()
    return counts, fit.to(torch.float32)
