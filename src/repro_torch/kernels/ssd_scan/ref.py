"""Plain PyTorch version of the SSD-scan kernel: the per-timestep recurrence.

The CPU path and, on the card, the oracle ``chip_smoke.py`` holds the CUDA
kernel to.  Same semantics as the JAX package's ``kernels/ssd_scan/ref.py``,
and it also returns the final state, which prefill hands to decode.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_scan_ref", "ssd_scan_model_ref"]


def ssd_scan_ref(x, dt, a, bm, cm):
    """Per-head layout: x (BH, S, P), dt (BH, S), a (BH,), bm/cm (BH, S, N)
    -> y (BH, S, P) in x's dtype and the final state h (BH, P, N) float32.

    h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t ;  h_0 = 0."""
    BH, S, P = x.shape
    N = bm.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), bm.float(), cm.float()
    af = a.float()
    h = torch.zeros((BH, P, N), dtype=torch.float32, device=x.device)
    ys = torch.empty((BH, S, P), dtype=torch.float32, device=x.device)
    for s in range(S):
        h = (h * torch.exp(dtf[:, s] * af)[:, None, None]
             + (dtf[:, s, None] * xf[:, s])[:, :, None] * bf[:, s, None, :])
        ys[:, s] = torch.bmm(h, cf[:, s, :, None])[..., 0]
    return ys.to(x.dtype), h


def ssd_scan_model_ref(x, dt, a, bm, cm):
    """Model layout: x (B, S, H, P), dt (B, S, H), a (H,), bm/cm (B, S, G, N)
    -> y (B, S, H, P) in x's dtype and h (B, H, P, N) float32.  Folds (B, H)
    and broadcasts the B/C groups as the JAX package's ``ssd_scan/ops.py:14-30``
    does, then runs ``ssd_scan_ref``."""
    B, S, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    rep = H // G
    xf = x.permute(0, 2, 1, 3).reshape(B * H, S, P)
    dtf = dt.permute(0, 2, 1).reshape(B * H, S)
    af = a.repeat(B)
    bmh = bm.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).reshape(B * H, S, N)
    cmh = cm.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3).reshape(B * H, S, N)
    y, h = ssd_scan_ref(xf, dtf, af, bmh, cmh)
    return y.reshape(B, H, S, P).permute(0, 2, 1, 3).contiguous(), h.reshape(B, H, P, N)
