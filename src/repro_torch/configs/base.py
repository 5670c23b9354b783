"""Architecture registry scaffolding: ``ArchDef`` and the smoke batch.

Every ported architecture module defines ``ARCH = ArchDef(...)`` with the
published config and a reduced smoke config of the same family, copied
field for field from the JAX package's ``configs/``.  The reference's
``input_specs`` and ``decode_operand_specs`` (shape stand-ins for its
dry-run) are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig

__all__ = ["ArchDef", "FULL_ATTN_SKIP", "smoke_batch"]


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


FULL_ATTN_SKIP = (
    ("long_500k", "skipped (full-attention arch; 524288-token dense prefill/"
                  "decode cache is outside the published model family — DESIGN.md §4)"),
)


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
