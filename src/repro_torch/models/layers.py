"""Shared building blocks of the LM slice: norms, rotary embeddings,
attention, MLP, the pre-norm dense layer, and the parameter tree.

Mirrors the JAX package's ``models/layers.py``:

* attention weights keep the unflattened head layout: q/k/v (D, H, hd),
  out (H, hd, D);
* KV caches are (B, S_max, K, hd) per layer, indexed by position;
* weights are stored in ``cfg.param_dtype`` and cast to the compute dtype at
  use (``.to`` is free once ``lm.to_compute_dtype_`` made a copy in it);
  norms, softmax and rotary run in float32.

Every no-cache self-attention (forward and prefill) goes through the
flash-attention op (the CUDA kernel on the card); the cached decode path is
plain torch (``_sdpa``), as the reference computes it outside any kernel
(``layers.py:137-169``).  Not ported: ``_proj``'s ``pmm`` branch (training
with gradient sharding), ``layer_norm`` and ``sinusoidal_pos`` (encdec),
cross-attention and ``precomputed_kv`` (encdec), and ``_sdpa_q_chunked``,
which nothing here reaches with the flash kernel on the no-cache path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig

__all__ = [
    "Params", "normal", "rms_norm", "rotary", "apply_rope", "KVCache", "init_attn",
    "attention", "init_mlp", "mlp", "init_dense_layer", "dense_layer",
]


class Params(nn.Module):
    """A tree of frozen parameters built from nested dicts, with the
    reference's names: a tensor becomes an ``nn.Parameter`` (no gradient), a
    dict a ``Params`` and a list an ``nn.ModuleList``.  ``p["q"]`` reads as
    in the reference's param trees."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, dict):
                self.add_module(name, Params(value))
            else:
                self.add_module(name, nn.ModuleList(Params(v) for v in value))

    def __getitem__(self, name: str):
        return getattr(self, name)


def normal(gen: torch.Generator, shape, cfg: ModelConfig, scale: float) -> torch.Tensor:
    """``scale * N(0, 1)`` of ``shape`` in ``cfg.param_dtype``, drawn from ``gen``
    on its device (the reference's ``jax.random.normal(k, shape, dtype) * s``)."""
    return torch.randn(shape, generator=gen, device=gen.device, dtype=cfg.param_dtype) * scale


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


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
              collect_kv: bool = False):
    """Self-attention for forward, prefill and decode.  Returns (out, cache).

    Without a cache (forward, prefill) it runs the flash-attention op and,
    with ``collect_kv``, returns the fresh post-rope K/V as the cache.  With
    a cache (decode) it writes the new K/V into ``cache`` in place at ``pos``
    and attends to the prefix ``[0, pos + S)``: the same result as the
    reference's attention over the padded cache with its ``kv_len`` mask,
    whose masked keys weigh exactly 0."""
    B, S, D = x.shape
    q = _proj_heads(x, p["q"])
    k = _proj_heads(x, p["k"])
    v = _proj_heads(x, p["v"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    offset = 0 if pos is None else pos
    cos, sin = rotary(torch.arange(S, device=x.device) + offset, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is None:
        o = flash_attention(q, k, v, causal=causal)
        new_cache = KVCache(k, v) if collect_kv else None
    else:
        cache.k[:, pos:pos + S] = k
        cache.v[:, pos:pos + S] = v
        o = _sdpa(q, cache.k[:, :pos + S], cache.v[:, :pos + S], causal=causal, q_offset=pos)
        new_cache = cache
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
