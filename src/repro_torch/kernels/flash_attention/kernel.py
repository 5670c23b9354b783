"""CUDA wrapper of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the JAX package's Pallas kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/kernel.py:78``).  The source states the
design and the bound.

The launcher routes by dtype: bfloat16 goes to the ``wgmma`` body (TMA-fed,
128 query rows per block), float32 to the CUDA-core body.  The bfloat16 body
needs hd a multiple of 8 (its TMA strides are multiples of 16 bytes) and
16-byte aligned pointers: other widths are zero-padded here (a zero column
adds nothing to a score, and the scale stays ``hd ** -0.5`` of the real hd),
and the padded columns of the output are dropped.

Tolerance against ``ref.attention_ref``: the kernel sums the scores and the
weighted values in float32 in another order (online softmax over key
tiles), so float32 outputs agree within 2e-5 and bfloat16 outputs within
2e-2 max-abs (one bf16 rounding of the outputs; the bf16 body also rounds
the weights to bf16 before PV, as the model's ``_sdpa`` does), as the
reference's ``tests/test_kernels.py:145`` holds its Pallas kernel.

``launches`` counts the kernel's launches; it is incremented only where the
kernel is launched.

``flash_attention_cuda`` is a ``torch.library.custom_op``
(``repro_torch::flash_attention``), so that a trace on fake tensors (the
dry-run, ``launch/dryrun.py``) sees one op: its ``register_fake`` gives the
output (B, Sq, H, hd) in q's dtype on q's device and launches nothing, and
its FLOP formula (``torch.utils.flop_counter``) counts ``4 B H Sq Skv hd``,
the two products, as the formula of ``scaled_dot_product_attention``
counts them, causal or not.  On real tensors the op runs the launch below
and nothing else.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build

__all__ = ["flash_attention_cuda", "flash_attention_flops", "launches"]

launches = 0
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fake: bool = False) -> None:
    """Raises on what the kernel does not take (``fake``: meta tensors too)."""
    if not all((x.is_cuda or (fake and x.is_meta)) and x.device == q.device for x in (q, k, v)):
        raise ValueError("flash_attention_cuda: tensors must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: q, k, v must share a dtype in "
                        f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or Kh == 0 or H % Kh != 0:
        raise ValueError(f"flash_attention_cuda: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (H must be a multiple of Kh)")
    if not 0 < hd <= MAX_HEAD_DIM or B * H > 65535 or Skv == 0:
        raise ValueError(f"flash_attention_cuda: hd={hd}, B*H={B * H}, Skv={Skv} "
                         f"outside 0 < hd <= {MAX_HEAD_DIM}, B*H <= 65535, Skv > 0")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: tensors must be contiguous")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, Kh, hd), contiguous, float32 or bfloat16
    -> (B, Sq, H, hd) in q's dtype."""
    global launches
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    if B * Sq * H == 0:
        return torch.empty_like(q)
    scale = hd ** -0.5
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(x) for x in (q, k, v))
    out = torch.empty_like(q)
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.launch_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     B, Sq, Skv, H, Kh, q.shape[3], int(causal),
                                     _DTYPES[q.dtype], scale, stream)
    _build.check(err, "flash_attention")
    launches += 1
    return out if out.shape[3] == hd else out[..., :hd].contiguous()


@flash_attention_cuda.register_fake
def _(q, k, v, *, causal=True):
    _check(q, k, v, fake=True)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_attention_flops(q_shape, k_shape, v_shape, *, causal=True, out_shape=None) -> int:
    """``4 B H Sq Skv hd``: QK^T and PV, each ``2 B H Sq Skv hd``."""
    B, Sq, H, hd = q_shape
    return 4 * B * H * Sq * k_shape[1] * hd


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """x with its last dim zero-padded to a multiple of 8 and its data 16-byte
    aligned, as the bfloat16 body's tensor maps need (a no-op for the
    model's widths)."""
    pad = -x.shape[3] % 8
    if pad:
        return torch.nn.functional.pad(x, (0, pad))
    return x if x.data_ptr() % 16 == 0 else x.clone()
