"""Decoder language model of the LM slice: the dense, moe, ssm, hybrid and vlm
families, after the JAX package's ``models/lm.py``.  One init and three entry points,
``forward`` (full-sequence logits), ``prefill`` and ``decode``.

Layers are an ``nn.ModuleList`` walked by a Python loop (no ``lax.scan``, no
remat).  The entry points run under ``torch.inference_mode``: the slice
serves, and training is not ported (ROADMAP A11).  Caches keep the
reference's stacked layout and are updated in place:

  dense, moe : KVCache (L, B, S_max, K, hd)
  vlm        : the same; the prompt is [patch_embeds ; text], so the cache
               holds the patches' positions first and decode positions are
               offset by ``n_img``
  ssm        : SSMState stacked (L, ...)
  hybrid     : (SSMState stacked (L, ...), KVCache (L/k, B, S_max, K, hd)),
               one KV cache per call of the shared attention block

The encoder-decoder family is ``models/encdec.py``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import ModelConfig
from .layers import (
    KVCache, Params, attention, dense_layer, init_attn, init_dense_layer, normal, rms_norm,
)
from .moe import init_moe, moe_block
from .ssm import SSMState, init_ssm_block, init_ssm_state, ssm_block, ssm_block_decode

__all__ = ["init_params", "to_compute_dtype_", "forward", "init_cache", "prefill", "decode",
           "unembed"]

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
_KV_FAMILIES = ("dense", "moe", "vlm")          # one attention layer per layer
# weights that every use casts to the compute dtype (the matmul operands);
# the MoE router and shared-expert gate stay float32, as the reference
# computes with them (moe.py:88, :157)
_MATMUL_WEIGHTS = ("q", "k", "v", "out", "up", "gate", "down", "in_proj", "out_proj",
                   "embed", "lm_head", "e_gate", "e_up", "e_down")


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown decoder family {cfg.family!r} (encdec: models/encdec.py)")
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
    JAX's (``convert.lm_params_from_numpy`` carries the reference's own).
    The matmul weights are stored in the compute dtype as each layer is
    drawn (``to_compute_dtype_``), so the whole tree is never held in
    ``param_dtype``: qwen2-moe-a2.7b's float32 draws alone would be 57 GB."""
    _check(cfg)
    finish = lambda t: to_compute_dtype_(Params(t), cfg)
    D, V = cfg.d_model, cfg.vocab_size
    tree: Dict[str, object] = {
        "embed": normal(gen, (V, D), cfg, D ** -0.5),
        "final_norm": torch.zeros((D,), dtype=cfg.param_dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal(gen, (D, V), cfg, D ** -0.5)
    layer = {"dense": init_dense_layer, "vlm": init_dense_layer, "moe": _init_moe_layer,
             "ssm": init_ssm_block, "hybrid": init_ssm_block}[cfg.family]
    tree["layers"] = [finish(layer(gen, cfg)) for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        tree["shared_attn"] = init_dense_layer(gen, cfg)
    return finish(tree)


def _init_moe_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device)
    return {"ln1": zeros(), "attn": init_attn(gen, cfg), "ln2": zeros(),
            "moe": init_moe(gen, cfg)}


def _attn_layer(lp, x: torch.Tensor, cfg: ModelConfig, **kw):
    """One pre-norm attention layer of the dense, vlm (MLP) or moe family."""
    if cfg.family != "moe":
        return dense_layer(lp, x, cfg, **kw)
    h, kv = attention(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, **kw)
    x = x + h
    return x + moe_block(lp["moe"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg), kv


@torch.no_grad()
def to_compute_dtype_(params: Params, cfg: ModelConfig) -> Params:
    """Store every matmul weight in the compute dtype, once, in place
    (``init_params`` does it layer by layer; trees from ``convert`` come in
    ``param_dtype``).

    Each use casts these to the compute dtype anyway, so the results do not
    change; a decode step stops re-casting ~all of the weights.  The other
    parameters (norm scales, ``A_log``, ``dt_bias``, the conv taps, which
    decode uses in float32; the MoE router and shared-expert gate) keep
    their dtype."""
    for name, p in params.named_parameters():
        if name.rsplit(".", 1)[-1] in _MATMUL_WEIGHTS:
            p.data = p.data.to(cfg.dtype)
    return params


def unembed(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ w.to(h.dtype)).to(cfg.logit_dtype)


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.dtype)


def _inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """The embedded prompt; vlm puts the patch embeddings (B, n_img, D) first."""
    x = _embed(params, batch["tokens"], cfg)
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# forward and prefill share the full-sequence path
# ---------------------------------------------------------------------------


def _split_cache(cfg: ModelConfig, cache):
    """(stacked SSM states or None, stacked KV cache or None)."""
    if cache is None:
        return None, None
    if cfg.family in _KV_FAMILIES:
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
        if cfg.family in _KV_FAMILIES:
            x, kv = _attn_layer(lp, x, cfg, collect_kv=fill)
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
    """Full-sequence forward -> logits (B, S, V) of the text positions."""
    _check(cfg)
    x = _layers(params, _inputs(params, batch, cfg), cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, batch["patch_embeds"].shape[1]:]
    return unembed(params, x, cfg)


# ---------------------------------------------------------------------------
# caches and serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zero caches for ``batch`` sequences of up to ``max_len`` positions; K/V
    in the compute dtype, SSM states in float32."""
    _check(cfg)
    states = None
    if cfg.family not in _KV_FAMILIES:
        st = init_ssm_state(cfg, batch, device=device)
        states = SSMState(*(a.new_zeros((cfg.n_layers,) + a.shape) for a in st))
        if cfg.family == "ssm":
            return states
    dense = cfg.family in _KV_FAMILIES
    n_kv = cfg.n_layers if dense else cfg.n_layers // _hybrid_period(cfg)
    shape = (n_kv, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kv = KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                 torch.zeros(shape, dtype=cfg.dtype, device=device))
    return kv if dense else (states, kv)


@torch.inference_mode()
def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_len: Optional[int] = None):
    """Run the prompt and fill the caches.  Returns (last-token logits
    (B, 1, V), cache).  The prompt is ``total`` = S positions, n_img + S for
    vlm; the K/V cache holds ``max(max_len, total)`` positions in the compute
    dtype, zero past the prompt, as the reference pads it (``lm.py:280-289``);
    decode continues by writing at pos = total."""
    _check(cfg)
    x = _inputs(params, batch, cfg)
    B, total = x.shape[:2]
    cache = init_cache(cfg, B, max(total, max_len or total), device=x.device)
    x = _layers(params, x, cfg, cache)
    x = rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg), cache


@torch.inference_mode()
def decode(params: Params, cache, token: torch.Tensor, pos: int, cfg: ModelConfig):
    """One decode step.  token (B, 1); ``pos`` the position it is written at
    (for vlm, counted after the ``n_img`` patch positions).  Returns (logits
    (B, 1, V), cache), the cache updated in place."""
    _check(cfg)
    x = _embed(params, token, cfg)
    states, kvs = _split_cache(cfg, cache)
    period = _hybrid_period(cfg)
    for i, lp in enumerate(params["layers"]):
        if cfg.family in _KV_FAMILIES:
            x, _ = _attn_layer(lp, x, cfg, cache=KVCache(kvs.k[i], kvs.v[i]), pos=pos)
            continue
        h, _ = ssm_block_decode(lp, x, cfg, SSMState(states.conv[i], states.h[i]))
        x = x + h
        if cfg.family == "hybrid" and (i + 1) % period == 0:
            g = i // period
            x, _ = dense_layer(params["shared_attn"], x, cfg,
                               cache=KVCache(kvs.k[g], kvs.v[g]), pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg), cache
