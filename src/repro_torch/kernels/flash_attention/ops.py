"""Public flash-attention op: the device picks the implementation.

A CUDA tensor goes to the hand-written kernel (``kernel.py``), which launches
or raises; a CPU tensor goes to the plain version (``ref.py``).  There is no
fallback from one to the other.  A meta tensor (the dry-run's trace where
PyTorch is built without CUDA, ``launch/dryrun.py``) goes to the kernel's
op too, whose fake implementation gives the output's shape.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref

__all__ = ["flash_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention in the model layout: q (B, Sq, H, hd), k/v (B, Skv, Kh, hd)."""
    if q.is_cuda or q.is_meta:
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=causal)
    return attention_ref(q, k, v, causal=causal)
