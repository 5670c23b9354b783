"""Whisper-style encoder-decoder backbone, after the JAX package's
``models/encdec.py``.

The audio conv front end is a stub, as in the reference: the caller
supplies frame embeddings (B, S_enc, D).  The encoder adds sinusoidal
positions and runs bidirectional attention over the frames; the decoder is
a causal LM with cross-attention into the encoder states.

Every attention without a cache runs the flash-attention op (the CUDA
kernel on the card): the encoder's, the decoder's self-attention in
forward and prefill, and its cross-attention in forward and prefill.  A
decode step attends to its caches, the decoder's K/V and the encoder's
cross K/V computed once at prefill, with the plain ``_sdpa``.  Layers are a
Python loop; ``forward`` follows the caller's grad mode (the train step
differentiates it), ``prefill`` and ``decode`` run under
``torch.inference_mode`` (``torch.no_grad`` on DTensor params).  Caches
keep the reference's stacked layout and the self-attention cache is
updated in place.  With ``cfg.remat`` each
encoder and decoder layer of a forward that builds a graph runs under
``torch.utils.checkpoint`` (``lm.layer_runner``), as the reference wraps
each scanned body in ``jax.checkpoint``.  Each encoder and decoder layer
first pins the residual stream to the launcher's ``cfg.act_shard_spec``
(``layers.pin_act``), as the reference's bodies do.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (
    KVCache, Params, _contract, _proj_heads, _reduced, attention, fsdp_gathered, init_attn,
    init_mlp, mlp, normal, pin_act, rms_norm, serving, sinusoidal_pos,
)
from .lm import _finisher, layer_runner

__all__ = ["EncDecCache", "init_params", "forward", "prefill", "decode"]


class EncDecCache(NamedTuple):
    self_kv: KVCache     # (L, B, S_dec_max, K, hd)
    cross_kv: KVCache    # (L, B, S_enc, K, hd), computed at prefill


def _check(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"models.encdec serves the encdec family, not {cfg.family!r}")


def _zeros(gen: torch.Generator, cfg: ModelConfig) -> torch.Tensor:
    return torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device)


def _init_enc_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"ln1": _zeros(gen, cfg), "attn": init_attn(gen, cfg), "ln2": _zeros(gen, cfg),
            "mlp": init_mlp(gen, cfg)}


def _init_dec_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"ln1": _zeros(gen, cfg), "self_attn": init_attn(gen, cfg),
            "ln_x": _zeros(gen, cfg), "cross_attn": init_attn(gen, cfg),
            "ln2": _zeros(gen, cfg), "mlp": init_mlp(gen, cfg)}


def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                for_training: bool = False) -> Params:
    """Random parameters on ``gen``'s device with the reference's
    distributions and scales (``encdec.py:33-67``); torch's draws.  The
    matmul weights are stored in the compute dtype as each layer is drawn
    unless ``for_training`` keeps them in ``param_dtype``, as in
    ``lm.init_params``."""
    _check(cfg)
    finish = _finisher(cfg, for_training)
    D, V = cfg.d_model, cfg.vocab_size
    return finish({
        "embed": normal(gen, (V, D), cfg, D ** -0.5),
        "enc_layers": [finish(_init_enc_layer(gen, cfg)) for _ in range(cfg.n_enc_layers)],
        "dec_layers": [finish(_init_dec_layer(gen, cfg)) for _ in range(cfg.n_layers)],
        "enc_norm": _zeros(gen, cfg),
        "final_norm": _zeros(gen, cfg),
        "lm_head": normal(gen, (D, V), cfg, D ** -0.5),
    })


def _enc_layer(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = pin_act(x, cfg)
    h, _ = attention(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                     causal=False, use_rope=False)
    x = x + h
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)


def _encode(params: Params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, S_enc, D) stub embeddings -> encoder states, in the compute dtype."""
    B, S, D = frames.shape
    run = layer_runner(cfg, fill=False)
    x = frames.to(cfg.dtype)
    x = x + sinusoidal_pos(S, D, x.dtype, device=x.device)[None]
    for lp in params["enc_layers"]:
        x = run(_enc_layer, lp, x, cfg)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(params: Params, enc: torch.Tensor) -> KVCache:
    """Each decoder layer's cross-attention K/V of the encoder states,
    stacked (L, B, S_enc, K, hd); no k-norm, no rope (``encdec.py:94-101``)."""
    layers = params["dec_layers"]
    return KVCache(torch.stack([_proj_heads(enc, lp["cross_attn"]["k"]) for lp in layers]),
                   torch.stack([_proj_heads(enc, lp["cross_attn"]["v"]) for lp in layers]))


def _dec_layer(lp, x: torch.Tensor, cfg: ModelConfig, enc: Optional[torch.Tensor],
               cross: Optional[KVCache], cache: Optional[KVCache], pos: Optional[int],
               fill: bool):
    """One decoder layer.  Returns (x, the prompt's K/V when ``fill``)."""
    x = pin_act(x, cfg)
    h, kv = attention(lp["self_attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                      causal=True, cache=cache, pos=pos, collect_kv=fill)
    x = x + h
    xin = rms_norm(x, lp["ln_x"], cfg.norm_eps)
    if cross is None:
        h, _ = attention(lp["cross_attn"], xin, cfg, causal=False, kv_x=enc, use_rope=False)
    else:
        h, _ = attention(lp["cross_attn"], xin, cfg, causal=False, pos=pos,
                         precomputed_kv=cross)
    x = x + h
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg), kv


def _dec_stack(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
               enc: Optional[torch.Tensor] = None, cross: Optional[KVCache] = None,
               self_kv: Optional[KVCache] = None, pos: Optional[int] = None,
               fill: bool = False) -> torch.Tensor:
    """The decoder over x.  Cross-attention reads fresh encoder states
    ``enc`` (forward) or the cached ``cross`` K/V (prefill and decode).
    With ``pos`` (decode) each layer attends to ``self_kv`` and writes its
    new K/V there; with ``fill`` (prefill) the prompt's K/V are written into
    ``self_kv`` from position 0, outside any checkpointed body."""
    S = x.shape[1]
    run = layer_runner(cfg, fill or pos is not None)
    for i, lp in enumerate(params["dec_layers"]):
        cache = None if pos is None else KVCache(self_kv.k[i], self_kv.v[i])
        cross_i = None if cross is None else KVCache(cross.k[i], cross.v[i])
        x, kv = run(_dec_layer, lp, x, cfg, enc, cross_i, cache, pos, fill)
        if fill:
            self_kv.k[i, :, :S] = kv.k
            self_kv.v[i, :, :S] = kv.v
    return x


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _contract(x, fsdp_gathered(params["lm_head"]), 1).to(cfg.logit_dtype)


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _reduced(F.embedding(tokens, params["embed"])).to(cfg.dtype)


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """Frames and decoder tokens -> decoder logits (B, S_dec, V)."""
    _check(cfg)
    enc = _encode(params, batch["frames"], cfg)
    x = _dec_stack(params, _embed(params, batch["tokens"], cfg), cfg, enc=enc)
    return _logits(params, x, cfg)


@serving
def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            max_dec_len: Optional[int] = None, self_kv: Optional[KVCache] = None):
    """Encode the frames, compute the cross K/V once and run the decoder
    prompt.  Returns (last-token logits (B, 1, V), ``EncDecCache``).  The
    self-attention cache holds ``max(max_dec_len or cfg.max_dec_len, S_dec)``
    positions in the compute dtype, zero past the prompt, as the reference
    pads it (``encdec.py:163-166``); ``self_kv``: a zero cache of that
    layout to fill instead (the dry-run passes it sharded)."""
    _check(cfg)
    enc = _encode(params, batch["frames"], cfg)
    cross = _cross_kv(params, enc)
    tokens = batch["tokens"]
    B, S_dec = tokens.shape
    if self_kv is None:
        shape = (cfg.n_layers, B, max(max_dec_len or cfg.max_dec_len, S_dec), cfg.n_kv_heads,
                 cfg.head_dim)
        self_kv = KVCache(torch.zeros(shape, dtype=cfg.dtype, device=tokens.device),
                          torch.zeros(shape, dtype=cfg.dtype, device=tokens.device))
    x = _dec_stack(params, _embed(params, tokens, cfg), cfg, cross=cross, self_kv=self_kv,
                   fill=True)
    return _logits(params, x[:, -1:], cfg), EncDecCache(self_kv, cross)


@serving
def decode(params: Params, cache: EncDecCache, token: torch.Tensor, pos: int,
           cfg: ModelConfig):
    """One decoder step.  token (B, 1) written at ``pos``.  Returns (logits
    (B, 1, V), cache), the self-attention cache updated in place."""
    _check(cfg)
    x = _dec_stack(params, _embed(params, token, cfg), cfg, cross=cache.cross_kv,
                   self_kv=cache.self_kv, pos=pos)
    return _logits(params, x, cfg), cache
