"""Plain PyTorch version of the flash-attention kernel: GQA attention with an
optional causal mask, float32 scores and softmax, output in q's dtype.

The CPU path and, on the card, the oracle that
``tests/test_torch_kernels_card.py`` holds the CUDA kernel to.  Same
semantics as the JAX package's ``kernels/flash_attention/ref.py``.
"""
from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, Kh, hd) -> (B, Sq, H, hd); query head h
    reads KV head h // (H / Kh); causal keeps key j <= query i (from 0)."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Kh, H // Kh, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * hd ** -0.5
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)
