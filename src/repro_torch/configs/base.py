"""Architecture registry scaffolding: ``ArchDef``, input specs, the smoke batch.

Every ported architecture module defines ``ARCH = ArchDef(...)`` with the
published config and a reduced smoke config of the same family, copied
field for field from the JAX package's ``configs/``.  ``input_specs`` and
``decode_operand_specs`` give empty tensors with the shapes and dtypes of
every (arch x shape) cell's operands, where the reference gives
``ShapeDtypeStruct``s: on ``"meta"`` they hold nothing, and the dry-run
makes them inside a ``FakeTensorMode`` on ``"cuda"``, so nothing is
allocated either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models import lm
from ..models.encdec import EncDecCache
from ..models.config import ModelConfig, ShapeSpec
from ..models.layers import KVCache

__all__ = ["ArchDef", "FULL_ATTN_SKIP", "smoke_batch", "input_specs", "decode_operand_specs"]


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    grad_accum: int = 1                      # microbatch accumulation, train_4k
    skip_shapes: Tuple[Tuple[str, str], ...] = ()   # (shape_name, reason)
    # pure data-parallel over all mesh axes (archs whose inner dims don't
    # divide the model axis, e.g. mamba2-130m with 24 ssm heads)
    dp_over_model: bool = False

    def skip_reason(self, shape_name: str) -> Optional[str]:
        for name, reason in self.skip_shapes:
            if name == shape_name:
                return reason
        return None


FULL_ATTN_SKIP = (
    ("long_500k", "skipped (full-attention arch; 524288-token dense prefill/"
                  "decode cache is outside the published model family — DESIGN.md §4)"),
)


def _tokens(shape, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=device)


def _dec_len(cfg: ModelConfig, S: int) -> int:
    return max(8, S // cfg.dec_ratio)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> Dict[str, torch.Tensor]:
    """Empty model inputs of a train or prefill cell (the reference's
    ``configs/base.py:54-79``): int32 tokens and, for train, labels;
    encdec bf16 ``frames`` (B, S, D) and ``max(8, S // dec_ratio)`` decoder
    tokens; vlm ``S - n_img`` text tokens and bf16 ``patch_embeds``."""
    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train"
    if cfg.family == "encdec":
        S_dec = _dec_len(cfg, S)
        specs = {"frames": torch.empty((B, S, cfg.d_model), dtype=torch.bfloat16, device=device),
                 "tokens": _tokens((B, S_dec), device)}
        if train:
            specs["labels"] = _tokens((B, S_dec), device)
        return specs
    if cfg.family == "vlm":
        n_img = cfg.n_img_tokens
        specs = {"tokens": _tokens((B, S - n_img), device),
                 "patch_embeds": torch.empty((B, n_img, cfg.d_model), dtype=torch.bfloat16,
                                             device=device)}
        if train:
            specs["labels"] = _tokens((B, S - n_img), device)
        return specs
    specs = {"tokens": _tokens((B, S), device)}
    if train:
        specs["labels"] = _tokens((B, S), device)
    return specs


def decode_operand_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta"):
    """(cache, token, pos, pos_ref) of a decode cell (the reference's
    ``configs/base.py:82-113``): the cache holds ``seq_len`` positions (the
    decoder's ``max(8, S // dec_ratio)`` for encdec, beside the encoder's
    ``S`` cross K/V), the token is int32 (B, 1).  The port's ``decode``
    takes ``pos`` as an int, so ``pos`` is the int ``pos_ref``, the last
    position, where the reference gives a 0-d int32 struct beside it."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        S_dec = _dec_len(cfg, S)
        def kv(s):
            shape = (cfg.n_layers, B, s, cfg.n_kv_heads, cfg.head_dim)
            return KVCache(*(torch.empty(shape, dtype=torch.bfloat16, device=device)
                             for _ in range(2)))
        cache = EncDecCache(self_kv=kv(S_dec), cross_kv=kv(S))
        pos_ref = S_dec - 1
    else:
        cache = lm.init_cache(cfg, B, S, device=device)
        pos_ref = S - 1
    return cache, _tokens((B, 1), device), pos_ref, pos_ref


def _bf16(a: np.ndarray, device) -> torch.Tensor:
    """float64 draws as bfloat16 (the bits of the reference's
    ``jnp.asarray(a, jnp.bfloat16)``)."""
    return torch.as_tensor(a, device=device).to(torch.bfloat16)


def smoke_batch(cfg: ModelConfig, *, batch: int = 2, seq: int = 32, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """Small concrete batch (train kind) from ``np.random.default_rng(seed)``,
    the same draws in the same order as the reference's ``smoke_batch``:
    encdec ``frames`` (bf16) and ``seq // dec_ratio`` (at least 8) decoder
    tokens; vlm ``seq - n_img`` (at least 4) text tokens and
    ``patch_embeds`` (bf16); otherwise ``seq`` tokens."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    ints = lambda shape: torch.as_tensor(rng.integers(0, V, shape), dtype=torch.int32,
                                         device=device)
    if cfg.family == "encdec":
        S_dec = max(8, seq // cfg.dec_ratio)
        return {"frames": _bf16(rng.normal(0, 1, (batch, seq, cfg.d_model)), device),
                "tokens": ints((batch, S_dec)), "labels": ints((batch, S_dec))}
    if cfg.family == "vlm":
        n_img = cfg.n_img_tokens
        S_text = max(4, seq - n_img)
        return {"tokens": ints((batch, S_text)),
                "patch_embeds": _bf16(rng.normal(0, 1, (batch, n_img, cfg.d_model)), device),
                "labels": ints((batch, S_text))}
    return {"tokens": ints((batch, seq)), "labels": ints((batch, seq))}
