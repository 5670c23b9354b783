"""Shared building blocks of the LM slice: norms, positions, rotary
embeddings, attention, MLP, the pre-norm dense layer, and the parameter tree.

Mirrors the JAX package's ``models/layers.py``:

* attention weights keep the unflattened head layout: q/k/v (D, H, hd),
  out (H, hd, D);
* KV caches are (B, S_max, K, hd) per layer, indexed by position;
* weights are cast to the compute dtype at use (``.to`` is free for the
  matmul weights, which ``lm.to_compute_dtype_`` stores in it); norms,
  softmax and rotary run in float32.

Every attention without a cache goes through the flash-attention op (the
CUDA kernel on the card): self-attention in forward and prefill, the
encoder's bidirectional attention, and cross-attention in forward and
prefill.  Attention against a cache, the decode step's self- and
cross-attention, is plain torch (``_sdpa``), as the reference computes it
outside any kernel (``layers.py:137-169``).  Not ported: ``_proj``'s ``pmm``
branch (training with gradient sharding) and ``_sdpa_q_chunked``, which no
path without a cache reaches here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig

__all__ = [
    "Params", "normal", "rms_norm", "layer_norm", "sinusoidal_pos", "rotary", "apply_rope",
    "KVCache", "init_attn", "attention", "init_mlp", "mlp", "init_dense_layer", "dense_layer",
]


class Params(nn.Module):
    """A tree of frozen parameters built from nested dicts, with the
    reference's names: a tensor becomes an ``nn.Parameter`` (no gradient), a
    dict a ``Params`` and a list an ``nn.ModuleList``; a ``Params`` is kept as
    it is.  ``p["q"]`` reads as in the reference's param trees."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, (dict, Params)):
                self.add_module(name, _params(value))
            else:
                self.add_module(name, nn.ModuleList(_params(v) for v in value))

    def __getitem__(self, name: str):
        return getattr(self, name)


def _params(value) -> Params:
    return value if isinstance(value, Params) else Params(value)


def normal(gen: torch.Generator, shape, cfg: ModelConfig, scale: float,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``scale * N(0, 1)`` of ``shape`` in ``dtype`` (default ``cfg.param_dtype``),
    drawn from ``gen`` on its device (the reference's
    ``jax.random.normal(k, shape, dtype) * s``), scaled in place."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype or cfg.param_dtype).mul_(scale)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def sinusoidal_pos(S: int, D: int, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """(S, D) sinusoidal positions: sin then cos of ``pos / 10000^(2i/D)``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def rotary(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for integer positions: (..., head_dim // 2) float32."""
    dim = torch.arange(head_dim // 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (2 * dim / head_dim))
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotary.  x (B, S, H, hd); cos/sin (S, hd//2) or (B, S, hd//2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, K, hd), or stacked (L, B, S_max, K, hd)
    v: torch.Tensor


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = D ** -0.5
    p = {
        "q": normal(gen, (D, H, hd), cfg, s),
        "k": normal(gen, (D, K, hd), cfg, s),
        "v": normal(gen, (D, K, hd), cfg, s),
        "out": normal(gen, (H, hd, D), cfg, (H * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=cfg.param_dtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=cfg.param_dtype, device=gen.device)
    return p


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: x (B, S, D) @ w (D, H, hd)."""
    D, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * hd)).reshape(*x.shape[:-1], H, hd)


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention with float32 scores and softmax, the weights
    cast to v's dtype before the PV product (the reference's ``_sdpa``).

    q (B, Sq, H, hd); k, v (B, Skv, K, hd), the valid prefix of the cache;
    ``q_offset`` is the position of q[0] for the causal mask."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * hd ** -0.5
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Skv, device=q.device)
        logits = logits.masked_fill(~(qpos[:, None] >= kpos[None, :]), -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return o.reshape(B, Sq, H, hd)


def attention(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
              cache: Optional[KVCache] = None, pos: Optional[int] = None,
              kv_x: Optional[torch.Tensor] = None, use_rope: bool = True,
              precomputed_kv: Optional[KVCache] = None, collect_kv: bool = False):
    """Self- or cross-attention for forward, prefill and decode.  Returns
    (out, cache).

    * Self-attention (neither ``kv_x`` nor ``precomputed_kv``) projects K/V
      from ``x`` and applies rope when ``use_rope``.  Without a cache
      (forward, prefill) it runs the flash-attention op and, with
      ``collect_kv``, returns the fresh post-rope K/V as the cache.  With a
      cache (decode) it writes the new K/V into ``cache`` in place at ``pos``
      and attends to the prefix ``[0, pos + S)``: the same result as the
      reference's attention over the padded cache with its ``kv_len`` mask,
      whose masked keys weigh exactly 0.
    * Cross-attention projects K/V from ``kv_x`` (forward), or reads them
      from ``precomputed_kv`` (prefill and decode: the encoder's K/V held in
      the cache); neither applies rope, and precomputed K/V take no k-norm.
      Precomputed K/V at a decode step (``pos`` given) are attended to with
      the plain ``_sdpa``, as any cache is; otherwise through the flash op.

    The flash op's causal mask is top-left aligned, so a causal call needs
    as many keys as queries."""
    B, S, D = x.shape
    q = _proj_heads(x, p["q"])
    if precomputed_kv is not None:
        k, v = precomputed_kv
    else:
        src = x if kv_x is None else kv_x
        k = _proj_heads(src, p["k"])
        v = _proj_heads(src, p["v"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if precomputed_kv is None:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and precomputed_kv is None and kv_x is None:
        offset = 0 if pos is None else pos
        cos, sin = rotary(torch.arange(S, device=x.device) + offset, cfg.head_dim,
                          cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None:
        cache.k[:, pos:pos + S] = k
        cache.v[:, pos:pos + S] = v
        o = _sdpa(q, cache.k[:, :pos + S], cache.v[:, :pos + S], causal=causal, q_offset=pos)
        new_cache = cache
    elif precomputed_kv is not None and pos is not None:
        o = _sdpa(q, k, v, causal=causal)
    else:
        if causal and k.shape[1] != S:
            raise ValueError(f"attention: a causal call needs as many keys as queries, "
                             f"got {k.shape[1]} keys for {S} queries")
        o = flash_attention(q, k, v, causal=causal)
        if collect_kv:
            new_cache = KVCache(k, v)
    H, hd = o.shape[2], o.shape[3]
    out = o.reshape(B, S, H * hd) @ p["out"].to(o.dtype).reshape(H * hd, D)
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    s_in, s_out = D ** -0.5, Fd ** -0.5
    p = {"up": normal(gen, (D, Fd), cfg, s_in), "down": normal(gen, (Fd, D), cfg, s_out)}
    if cfg.glu:
        p["gate"] = normal(gen, (D, Fd), cfg, s_in)
    return p


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = x @ p["up"].to(x.dtype)
    if cfg.glu:
        h = _act(x @ p["gate"].to(x.dtype), cfg.act) * up
    else:
        h = _act(up, cfg.act)
    return h @ p["down"].to(h.dtype)


# ---------------------------------------------------------------------------
# a full pre-norm dense transformer layer
# ---------------------------------------------------------------------------


def init_dense_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device)
    return {"ln1": zeros(), "attn": init_attn(gen, cfg), "ln2": zeros(),
            "mlp": init_mlp(gen, cfg)}


def dense_layer(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
                cache: Optional[KVCache] = None, pos: Optional[int] = None,
                collect_kv: bool = False):
    h, new_cache = attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                             causal=causal, cache=cache, pos=pos, collect_kv=collect_kv)
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x, new_cache
