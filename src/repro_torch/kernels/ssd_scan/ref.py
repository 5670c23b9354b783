"""Plain PyTorch version of the SSD-scan kernel: the per-timestep recurrence.

The CPU path and, on the card, the oracle that
``tests/test_torch_kernels_card.py`` holds the CUDA kernel to.  Same
semantics as the JAX package's ``kernels/ssd_scan/ref.py``, and it also
returns the final state, which prefill hands to decode.

``ssd_scan_chunked_ref`` is the chunked state-passing form that the bfloat16
CUDA body computes, as three plain passes (``ssd_chunk_states``,
``ssd_state_passing``, ``ssd_chunk_scan``), so that its algebra is tested
where there is no card.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_scan_ref", "ssd_scan_model_ref", "ssd_chunk_states", "ssd_state_passing",
           "ssd_chunk_scan", "ssd_scan_chunked_ref"]


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


def _chunked(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, ...) float32 -> (B, nc, chunk, ...), zero-padded past S: a zero
    dt adds no decay and a zero x or B adds no input."""
    B, S = t.shape[:2]
    nc = -(-S // chunk)
    t = t.float()
    if nc * chunk != S:
        t = torch.cat([t, t.new_zeros((B, nc * chunk - S) + t.shape[2:])], dim=1)
    return t.reshape((B, nc, chunk) + t.shape[2:])


def _log_decay(dt, a, chunk):
    """la (B, nc, Q, H): the cumulative log-decay from each chunk's start."""
    return torch.cumsum(_chunked(dt, chunk) * a.float(), dim=2)


def _per_head(m: torch.Tensor, H: int) -> torch.Tensor:
    """(B, nc, Q, G, N) -> (B, nc, Q, H, N): head h reads group h // (H / G)."""
    return m.repeat_interleave(H // m.shape[3], dim=3)


def ssd_chunk_states(x, dt, a, bm, chunk: int):
    """Pass 1.  Each chunk's own state s_c = (x * dt * exp(la_last - la))^T B,
    (B, H, nc, P, N) float32, and its total decay exp(la_last), (B, H, nc)."""
    la = _log_decay(dt, a, chunk)
    w = _chunked(dt, chunk) * torch.exp(la[:, :, -1:, :] - la)          # (B, nc, Q, H)
    u = _chunked(x, chunk) * w[..., None]
    states = torch.einsum("bcqhp,bcqhn->bhcpn", u, _per_head(_chunked(bm, chunk), x.shape[2]))
    return states, torch.exp(la[:, :, -1, :]).permute(0, 2, 1)


def ssd_state_passing(states, decay):
    """Pass 2.  The state entering each chunk, H_0 = 0 and
    H_{c+1} = decay_c H_c + s_c, (B, H, nc, P, N); and the final state."""
    h = torch.zeros_like(states[:, :, 0])
    entering = torch.empty_like(states)
    for c in range(states.shape[2]):
        entering[:, :, c] = h
        h = decay[:, :, c, None, None] * h + states[:, :, c]
    return entering, h


def ssd_chunk_scan(x, dt, a, bm, cm, entering, chunk: int):
    """Pass 3.  y = tril(C B^T o exp(la_i - la_j)) (x dt) + exp(la) o (C H_c^T),
    in x's dtype.  exp(la_i - la_j) is taken only for j <= i: above the
    diagonal it could overflow, and a mask applied after it would make NaN."""
    B, S, H, P = x.shape
    la = _log_decay(dt, a, chunk)                                      # (B, nc, Q, H)
    cmh, bmh = (_per_head(_chunked(m, chunk), H) for m in (cm, bm))    # (B, nc, Q, H, N)
    cb = torch.einsum("bcihn,bcjhn->bchij", cmh, bmh)
    diff = la.permute(0, 1, 3, 2)[..., :, None] - la.permute(0, 1, 3, 2)[..., None, :]
    lower = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(lower, diff, torch.full_like(diff, -torch.inf)))
    u = _chunked(x, chunk) * _chunked(dt, chunk)[..., None]            # (B, nc, Q, H, P)
    y = torch.einsum("bchij,bcjhp->bcihp", cb * decay, u)
    y = y + torch.exp(la)[..., None] * torch.einsum("bcihn,bhcpn->bcihp", cmh, entering)
    return y.reshape(B, -1, H, P)[:, :S].to(x.dtype)


def ssd_scan_chunked_ref(x, dt, a, bm, cm, *, chunk: int):
    """Model layout, as ``ssd_scan_model_ref``, by the three passes: y
    (B, S, H, P) in x's dtype and the final state (B, H, P, N) float32.  S
    need not be a multiple of ``chunk``."""
    states, decay = ssd_chunk_states(x, dt, a, bm, chunk)
    entering, h = ssd_state_passing(states, decay)
    return ssd_chunk_scan(x, dt, a, bm, cm, entering, chunk), h
