"""Public SSD-scan op in the model layout: the device picks the implementation.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), which reads
the model layout in place, launches or raises; a CPU tensor goes to the
plain version (``ref.ssd_scan_model_ref``, which folds (B, H) and broadcasts
the groups as the JAX package's ``ssd_scan/ops.py:14-30`` does).  There is no
fallback from one to the other; a meta tensor (the dry-run's trace where
PyTorch is built without CUDA, ``launch/dryrun.py``) goes to the kernel's
op, whose fake implementation gives the outputs' shapes.  Both take any S: the kernel runs a partial
last chunk, the plain version is per timestep.
"""
from __future__ import annotations

import torch

from .kernel import ssd_scan_cuda
from .ref import ssd_scan_model_ref

__all__ = ["ssd_scan"]


def ssd_scan(x, dt, a, bm, cm, *, block_q: int = 128):
    """x (B, S, H, P), dt (B, S, H), a (H,), bm/cm (B, S, G, N) -> y
    (B, S, H, P) in x's dtype and the final state (B, H, P, N) float32."""
    if x.is_cuda or x.is_meta:
        return ssd_scan_cuda(x, dt.float().contiguous(), a.float().contiguous(), bm, cm,
                             block_q=block_q)
    return ssd_scan_model_ref(x, dt, a, bm, cm)
