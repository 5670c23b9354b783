"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 — GQA 128k vocab.  [arXiv:2407.21783; unverified]

Parameters are stored in bf16 (the reference's choice for this size).
"""
import torch

from ..models.config import ModelConfig
from .base import ArchDef, FULL_ATTN_SKIP

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, head_dim=128, d_ff=53248,
    vocab_size=128256, rope_theta=5e5,
    param_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke", family="dense",
    n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512,
)

ARCH = ArchDef(
    arch_id="llama3-405b", config=CONFIG, smoke=SMOKE,
    optimizer="adafactor", grad_accum=16, skip_shapes=FULL_ATTN_SKIP,
)
