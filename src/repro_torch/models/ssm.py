"""Mamba-2 (SSD) block of the LM slice, after the JAX package's ``models/ssm.py``.

Forward and prefill start from a zero state and run the SSD scan op (the
CUDA kernel on the card, the per-timestep recurrence on the CPU), which also
returns the final state that decode continues from.  Decode is the O(1)
recurrence in plain torch, as in the reference.

``_ssd_chunked`` is the reference's blocked, differentiable SSD (bf16
intra-chunk tensors, float32 state passing), with its start from a state
``h0``.  It is the reference's training math: the scan op's autograd
``_SSDScan`` runs the op forward and takes its gradient from
``_ssd_chunked`` recomputed from the saved inputs.  The JAX package has no
backward kernel for its SSD kernel, so neither has the port.

State layout:
  conv state : (B, K-1, conv_dim) float32  -- last K-1 pre-conv inputs
  ssm state  : (B, H, P, N) float32        -- per-head outer-product state
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd_scan
from .config import ModelConfig
from .layers import _contract, grad_like_forward, local_kernel, normal, rms_norm, whole_dim

__all__ = ["SSMState", "init_ssm_block", "init_ssm_state", "ssm_block", "ssm_block_decode"]


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, conv_dim), or stacked (L, ...)
    h: torch.Tensor      # (B, H, P, N), or stacked (L, ...)


def _conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_ssm_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, d_inner, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    G, N = cfg.ssm_groups, cfg.ssm_state
    cd = _conv_dim(cfg)
    dev, pdt = gen.device, cfg.param_dtype
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "norm": torch.zeros((D,), dtype=pdt, device=dev),
        "in_proj": normal(gen, (D, 2 * d_inner + 2 * G * N + H), cfg, D ** -0.5),
        "conv_w": normal(gen, (cfg.ssm_conv, cd), cfg, 0.2),
        "conv_b": torch.zeros((cd,), dtype=pdt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).to(pdt),
        "D_skip": torch.ones((H,), dtype=pdt, device=dev),
        "dt_bias": torch.full((H,), math.log(math.expm1(0.01)), **f32).to(pdt),
        "gated_norm": torch.zeros((d_inner,), dtype=pdt, device=dev),
        "out_proj": normal(gen, (d_inner, D), cfg, d_inner ** -0.5),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> SSMState:
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, _conv_dim(cfg)), dtype=dtype, device=device),
        h=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=dtype,
                      device=device),
    )


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_inner, G, N = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    zxbcdt = whole_dim(zxbcdt, -1)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * G * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * G * N:]
    return z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, tap by tap as the reference sums it.
    xBC (B, S, Cd); w (K, Cd)."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def _ssd_chunked(x, dt, A, Bm, Cm, cfg: ModelConfig, h0=None):
    """Blocked SSD scan (the reference's ``ssm.py:80-144``).

    x (B, S, H, P); dt (B, S, H); A (H,) negative; Bm/Cm (B, S, G, N); h0
    (B, H, P, N) or None (zeros).  Returns y (B, S, H, P) in x's dtype and
    the final state (B, H, P, N) float32.  S must be a multiple of the chunk
    ``min(cfg.ssm_chunk, S)``, as the reference's reshape requires."""
    B_, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"_ssd_chunked: S={S} is not a multiple of the chunk {Q}")
    nc = S // Q
    rep = H // G

    xq = x.reshape(B_, nc, Q, H, P)
    dtq = dt.reshape(B_, nc, Q, H)
    Bq = Bm.reshape(B_, nc, Q, G, N)
    Cq = Cm.reshape(B_, nc, Q, G, N)

    la = torch.cumsum(dtq * A[None, None, None, :], dim=2)        # (B,nc,Q,H) log-decay
    u = xq * dtq[..., None]                                      # discretized input

    # intra-chunk: the Q x Q tensors stay in the compute dtype, the log-decay
    # math in float32
    # head h reads group h // rep, as jnp.repeat(., rep, axis=3); an expand,
    # since repeat_interleave with an int count reads its size back from
    # the device
    heads = lambda t: t[..., None, :].expand(B_, nc, Q, G, rep, N).reshape(B_, nc, Q, H, N)
    Bh, Ch = heads(Bq), heads(Cq)                                # (B,nc,Q,H,N)
    cb = torch.einsum("bnqhs,bnkhs->bnhqk", Ch, Bh)              # (B,nc,H,Q,Q)
    # the reference exponentiates every (q, k) pair and zeroes the upper
    # triangle after: there la_q - la_k > 0 overflows exp past 88.7 (it does
    # at zamba2-2.7b's full width, ROADMAP C4), and the zeroed entries'
    # gradient is then 0 * inf = NaN.  Masking the exponent to -inf first gives the same
    # values and a finite gradient.
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    expo = la[..., :, None, :] - la[..., None, :, :]             # (B,nc,Q,Q,H)
    decay = torch.exp(torch.where(mask[:, :, None], expo, -torch.inf)).to(x.dtype)
    att = cb * decay.permute(0, 1, 4, 2, 3)                      # (B,nc,H,Q,Q)
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", att.to(x.dtype), u.to(x.dtype))

    # chunk summary states and the inter-chunk recurrence
    seg = torch.exp(la[:, :, -1:, :] - la)                       # decay to chunk end
    chunk_state = torch.einsum("bnqhs,bnqhp->bnhps", (Bh * seg[..., None]).float(),
                               u.float())                        # (B,nc,H,P,N)
    chunk_decay = torch.exp(la[:, :, -1, :])                     # (B,nc,H)
    h = (torch.zeros((B_, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    h_enter = []
    for c in range(nc):
        h_enter.append(h)                                        # state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_enter = torch.stack(h_enter, dim=1)                        # (B,nc,H,P,N)

    indecay = torch.exp(la)                                      # decay from chunk start
    y_inter = torch.einsum("bnqhs,bnhps->bnqhp", (Ch * indecay[..., None]).float(),
                           h_enter).to(x.dtype)
    y = y_intra.float() + y_inter.float()
    return y.reshape(B_, S, H, P).to(x.dtype), h


class _SSDScan(torch.autograd.Function):
    """The SSD scan op with the reference's training gradient.

    Forward runs the op (the CUDA kernel for CUDA tensors, which launches
    or raises; its plain version on the CPU) and saves only the inputs.
    Backward recomputes ``_ssd_chunked`` from them, from a zero state as the
    op starts, and returns its autograd gradient.  The final state is not
    differentiable."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, cfg):
        y, h = ssd_scan(x, dt, A, Bm, Cm, block_q=min(cfg.ssm_chunk, x.shape[1]))
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, dy, _dh):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            y, _ = _ssd_chunked(*inputs, ctx.cfg)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if n else None for n in needs), None)


# the scan is local per batch row and per head (a head reads its group)
_SCAN_ROLES = ({"batch": 0, "head": 2}, {"batch": 0, "head": 2}, {"head": 0},
               {"batch": 0, "group": 2}, {"batch": 0, "group": 2})
_SCAN_OUT_ROLES = ({"batch": 0, "head": 2}, {"batch": 0, "head": 1})


def ssm_block(p, x: torch.Tensor, cfg: ModelConfig):
    """Mamba-2 block from a zero state (pre-norm, residual outside).
    x (B, S, D) -> (out (B, S, D), the state after the sequence)."""
    B_, S, D = x.shape
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = _contract(h, p["in_proj"], 1)
    z, conv_in, dt = _split_proj(zxbcdt, cfg)
    # the conv runs on each device's batch rows (over DTensors, whose padding
    # along a dim has no strategy in every PyTorch release)
    xBC = local_kernel(_causal_conv, (conv_in, p["conv_w"].to(conv_in.dtype),
                                      p["conv_b"].to(conv_in.dtype)),
                       ({"batch": 0}, {}, {}), ({"batch": 0},))

    d_inner, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    # views into the conv output; the kernel reads them through their strides
    xBC = whole_dim(xBC, -1)
    xs = xBC[..., :d_inner].reshape(B_, S, H, P)
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(B_, S, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(B_, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    y, h_final = local_kernel(lambda *a: _SSDScan.apply(*a, cfg), (xs, dt, A, Bm, Cm),
                              _SCAN_ROLES, _SCAN_OUT_ROLES)
    y = y + xs * p["D_skip"].to(y.dtype)[None, None, :, None]
    # its gradient, split back into heads, in the heads' layout
    y = grad_like_forward(y.reshape(B_, S, d_inner))
    y = rms_norm(y * F.silu(z), p["gated_norm"], cfg.norm_eps)
    out = _contract(y, p["out_proj"], 1)

    K = cfg.ssm_conv
    if S >= K - 1:
        conv_tail = conv_in[:, S - (K - 1):, :]
    else:
        conv_tail = torch.cat([conv_in.new_zeros((B_, K - 1 - S, conv_in.shape[2])), conv_in],
                              dim=1)
    return out, SSMState(conv=conv_tail.float(), h=h_final)


def _heads_from_groups(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, G, N) -> (B, H, N), head h reading group h // (H / G), as
    ``jnp.repeat(t, H // G, axis=1)``.  ``repeat_interleave`` with an int
    count would read its output size back from a CUDA device and stall the
    decode loop."""
    B_, G, N = t.shape
    return t[:, :, None, :].expand(B_, G, H // G, N).reshape(B_, H, N)


def ssm_block_decode(p, x: torch.Tensor, cfg: ModelConfig, state: SSMState):
    """One-token decode.  x (B, 1, D) -> (out (B, 1, D), state), where
    ``state`` is updated in place."""
    B_, S, D = x.shape
    if S != 1:
        raise ValueError(f"ssm_block_decode takes one token, got S={S}")
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = _contract(h, p["in_proj"], 1)
    z, xBC, dt = _split_proj(zxbcdt, cfg)

    # conv over (cached K-1 inputs ++ current)
    window = torch.cat([state.conv, xBC.to(state.conv.dtype)], dim=1)      # (B, K, Cd)
    w = p["conv_w"].to(window.dtype)
    conv_out = torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(window.dtype)
    xBC_t = whole_dim(F.silu(conv_out)[:, None, :].to(x.dtype), -1)       # (B, 1, Cd)

    d_inner, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    xs = xBC_t[..., :d_inner].reshape(B_, H, P)
    Bh = _heads_from_groups(xBC_t[..., d_inner:d_inner + G * N].reshape(B_, G, N), H)
    Ch = _heads_from_groups(xBC_t[..., d_inner + G * N:].reshape(B_, G, N), H)
    dt1 = F.softplus(dt[:, 0, :].float() + p["dt_bias"].float())           # (B, H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt1 * A[None, :])

    u = xs.float() * dt1[..., None]                                       # (B, H, P)
    h_new = state.h * a[..., None, None] + u[..., :, None] * Bh.float()[:, :, None, :]
    y = local_kernel(lambda h_, c_: torch.einsum("bhpn,bhn->bhp", h_, c_), (h_new, Ch.float()),
                     ({"batch": 0, "head": 1}, {"batch": 0, "head": 1}),
                     ({"batch": 0, "head": 1},)).to(x.dtype)
    y = y + xs * p["D_skip"].to(y.dtype)[None, :, None]
    y = y.reshape(B_, 1, d_inner)
    y = rms_norm(y * F.silu(z), p["gated_norm"], cfg.norm_eps)
    out = _contract(y, p["out_proj"], 1)
    state.conv.copy_(window[:, 1:, :])
    state.h.copy_(h_new)
    return out, state
