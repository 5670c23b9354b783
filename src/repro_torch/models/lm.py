"""Decoder language model of the LM slice: the dense, ssm and hybrid families,
after the JAX package's ``models/lm.py``.  One init and three entry points,
``forward`` (full-sequence logits), ``prefill`` and ``decode``.

Layers are an ``nn.ModuleList`` walked by a Python loop (no ``lax.scan``, no
remat).  The entry points run under ``torch.inference_mode``: the slice
serves, and training is not ported (ROADMAP A11).  Caches keep the
reference's stacked layout and are updated in place:

  dense  : KVCache (L, B, S_max, K, hd)
  ssm    : SSMState stacked (L, ...)
  hybrid : (SSMState stacked (L, ...), KVCache (L/k, B, S_max, K, hd)), one
           KV cache per call of the shared attention block

The moe and vlm families (and encdec, ``models/encdec.py``) are not ported
yet: they raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import ModelConfig
from .layers import KVCache, Params, dense_layer, init_dense_layer, normal, rms_norm
from .ssm import SSMState, init_ssm_block, init_ssm_state, ssm_block, ssm_block_decode

__all__ = ["init_params", "to_compute_dtype_", "forward", "init_cache", "prefill", "decode",
           "unembed"]

PORTED_FAMILIES = ("dense", "ssm", "hybrid")
# weights that every use casts to the compute dtype (the matmul operands)
_MATMUL_WEIGHTS = ("q", "k", "v", "out", "up", "gate", "down", "in_proj", "out_proj",
                   "embed", "lm_head")


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        if cfg.family in ("moe", "vlm", "encdec"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to repro_torch yet (ROADMAP A11)")
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family == "hybrid" and cfg.n_layers % _hybrid_period(cfg):
        raise ValueError(f"hybrid: n_layers={cfg.n_layers} is not a multiple of "
                         f"shared_attn_every={cfg.shared_attn_every}")


def _hybrid_period(cfg: ModelConfig) -> int:
    return cfg.shared_attn_every or cfg.n_layers


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen``'s device, with the reference's
    distributions and scales (``lm.py:42-74``); the draws are torch's, not
    JAX's (``convert.lm_params_from_numpy`` carries the reference's own)."""
    _check(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    tree: Dict[str, object] = {
        "embed": normal(gen, (V, D), cfg, D ** -0.5),
        "final_norm": torch.zeros((D,), dtype=cfg.param_dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal(gen, (D, V), cfg, D ** -0.5)
    if cfg.family == "dense":
        tree["layers"] = [init_dense_layer(gen, cfg) for _ in range(cfg.n_layers)]
    else:
        tree["layers"] = [init_ssm_block(gen, cfg) for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        tree["shared_attn"] = init_dense_layer(gen, cfg)
    return Params(tree)


@torch.no_grad()
def to_compute_dtype_(params: Params, cfg: ModelConfig) -> Params:
    """Store every matmul weight in the compute dtype, once, in place.

    Each use casts these to the compute dtype anyway, so the results do not
    change; a decode step stops re-casting ~all of the weights.  The other
    parameters (norm scales, ``A_log``, ``dt_bias``, the conv taps, which
    decode uses in float32) keep ``param_dtype``."""
    for name, p in params.named_parameters():
        if name.rsplit(".", 1)[-1] in _MATMUL_WEIGHTS:
            p.data = p.data.to(cfg.dtype)
    return params


def unembed(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ w.to(h.dtype)).to(cfg.logit_dtype)


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.dtype)


# ---------------------------------------------------------------------------
# forward and prefill share the full-sequence path
# ---------------------------------------------------------------------------


def _split_cache(cfg: ModelConfig, cache):
    """(stacked SSM states or None, stacked KV cache or None)."""
    if cache is None:
        return None, None
    if cfg.family == "dense":
        return None, cache
    if cfg.family == "ssm":
        return cache, None
    return cache


def _layers(params: Params, x: torch.Tensor, cfg: ModelConfig, cache=None) -> torch.Tensor:
    """Every layer over the full sequence; with ``cache`` (prefill), the
    fresh K/V and the SSM states are written into it."""
    fill = cache is not None
    states, kvs = _split_cache(cfg, cache)
    S = x.shape[1]
    period = _hybrid_period(cfg)
    for i, lp in enumerate(params["layers"]):
        if cfg.family == "dense":
            x, kv = dense_layer(lp, x, cfg, collect_kv=fill)
            if fill:
                kvs.k[i, :, :S] = kv.k
                kvs.v[i, :, :S] = kv.v
            continue
        h, st = ssm_block(lp, x, cfg)
        x = x + h
        if fill:
            states.conv[i] = st.conv
            states.h[i] = st.h
        if cfg.family == "hybrid" and (i + 1) % period == 0:
            x, kv = dense_layer(params["shared_attn"], x, cfg, collect_kv=fill)
            if fill:
                g = i // period
                kvs.k[g, :, :S] = kv.k
                kvs.v[g, :, :S] = kv.v
    return x


@torch.inference_mode()
def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    _check(cfg)
    x = _layers(params, _embed(params, batch["tokens"], cfg), cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg)


# ---------------------------------------------------------------------------
# caches and serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zero caches for ``batch`` sequences of up to ``max_len`` positions; K/V
    in the compute dtype, SSM states in float32."""
    _check(cfg)
    states = None
    if cfg.family != "dense":
        st = init_ssm_state(cfg, batch, device=device)
        states = SSMState(*(a.new_zeros((cfg.n_layers,) + a.shape) for a in st))
        if cfg.family == "ssm":
            return states
    n_kv = cfg.n_layers if cfg.family == "dense" else cfg.n_layers // _hybrid_period(cfg)
    shape = (n_kv, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv = KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                 torch.zeros(shape, dtype=cfg.dtype, device=device))
    return kv if cfg.family == "dense" else (states, kv)


@torch.inference_mode()
def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Run the prompt and fill the caches.  Returns (last-token logits
    (B, 1, V), cache).  The K/V cache holds ``max(max_len, S)`` positions in
    the compute dtype, zero past the prompt, as the reference pads it
    (``lm.py:280-289``); decode continues by writing at pos = S."""
    _check(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, max(S, max_len or S), device=tokens.device)
    x = _layers(params, _embed(params, tokens, cfg), cfg, cache)
    x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg), cache


@torch.inference_mode()
def decode(params: Params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig):
    """One decode step.  token (B, 1); ``pos`` the position it is written at.
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    _check(cfg)
    x = _embed(params, token, cfg)
    states, kvs = _split_cache(cfg, cache)
    period = _hybrid_period(cfg)
    for i, lp in enumerate(params["layers"]):
        if cfg.family == "dense":
            x, _ = dense_layer(lp, x, cfg, cache=KVCache(kvs.k[i], kvs.v[i]), pos=pos)
            continue
        h, _ = ssm_block_decode(lp, x, cfg, SSMState(states.conv[i], states.h[i]))
        x = x + h
        if cfg.family == "hybrid" and (i + 1) % period == 0:
            g = i // period
            x, _ = dense_layer(params["shared_attn"], x, cfg,
                               cache=KVCache(kvs.k[g], kvs.v[g]), pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg), cache
