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


def smoke_batch(cfg: ModelConfig, *, batch: int = 2, seq: int = 32, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """Small concrete token batch (train kind) from ``np.random.default_rng(seed)``,
    the same draws as the reference's ``smoke_batch``."""
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet (ROADMAP A11)")
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    return {
        "tokens": torch.as_tensor(rng.integers(0, V, (batch, seq)), dtype=torch.int32,
                                  device=device),
        "labels": torch.as_tensor(rng.integers(0, V, (batch, seq)), dtype=torch.int32,
                                  device=device),
    }
