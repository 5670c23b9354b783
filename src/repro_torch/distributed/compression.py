"""Gradient compression, after the JAX package's ``distributed/compression.py``:
error-feedback int8 quantization and a compressed all-reduce over a
``torch.distributed`` process group.

``compressed_psum`` is the classic int8 all-reduce:
  1. split the (flattened) gradient into one chunk per rank;
  2. ``all_to_all`` the *quantized* chunks (wire bytes / 4 vs float32);
  3. locally dequantize and reduce the owned chunk;
  4. re-quantize and ``all_gather`` the reduced chunks (again int8).
Wire traffic ~ 0.5x the tensor's size vs 2x for a plain float32 ring
all-reduce.

``ErrorFeedback`` keeps the classic residual so the quantization error is
re-injected next step (convergence-preserving; Karimireddy et al.).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["quantize_int8", "dequantize_int8", "ErrorFeedback", "ef_compress",
           "compressed_psum"]


def quantize_int8(x: torch.Tensor):
    """(q int8, scale float32 0-d): one scale for the whole tensor, rounded
    half to even as the reference's ``jnp.round``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class ErrorFeedback(NamedTuple):
    residual: torch.Tensor


def ef_compress(g: torch.Tensor, ef: ErrorFeedback):
    """Error-feedback quantize: returns (q, scale, new_ef)."""
    corrected = g.to(torch.float32) + ef.residual
    q, scale = quantize_int8(corrected)
    new_res = corrected - dequantize_int8(q, scale)
    return q, scale, ErrorFeedback(new_res)


def _all_gather(t: torch.Tensor, k: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(k)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def compressed_psum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """int8-transport all-reduce of ``x`` over ``group`` (default: the world),
    called on every rank.  x: (N,) float32 with N divisible by the group's
    size; every rank gets the same (N,) sum."""
    k = dist.get_world_size(group)
    n = x.shape[0]
    if n % k:
        raise ValueError(f"compressed_psum: {n} elements do not split over {k} ranks")
    chunks = x.reshape(k, n // k)
    q, scale = quantize_int8(chunks)                           # int8 (k, n/k)
    # each rank receives everyone's copy of its owned chunk
    q_t = torch.empty_like(q)
    dist.all_to_all_single(q_t, q.contiguous(), group=group)   # (k, n/k) int8
    scales = _all_gather(scale.reshape(1), k, group)[:, 0]     # (k,)
    owned = torch.sum(q_t.to(torch.float32) * scales[:, None], dim=0)   # (n/k,)
    q2, s2 = quantize_int8(owned)
    gathered = _all_gather(q2, k, group)                       # (k, n/k) int8
    s_all = _all_gather(s2.reshape(1), k, group)[:, 0]         # (k,)
    return (gathered.to(torch.float32) * s_all[:, None]).reshape(n)
