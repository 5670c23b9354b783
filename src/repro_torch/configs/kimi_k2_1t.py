"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 routed top-8 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

1T params: bf16 params + Adafactor + EP (384 % 16 == 0) over the model
axis.  head_dim = 7168/64 = 112 per the assigned spec (the real model uses
MLA; noted in DESIGN.md §9).
"""
import torch

from ..models.config import ModelConfig
from .base import ArchDef, FULL_ATTN_SKIP

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, head_dim=112, d_ff=2048,
    vocab_size=163840, rope_theta=5e4,
    n_experts=384, n_shared_experts=0, moe_top_k=8, capacity_factor=1.25,
    param_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe",
    n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
    vocab_size=512,
    n_experts=8, n_shared_experts=0, moe_top_k=4, capacity_factor=1.25,
)

ARCH = ArchDef(
    arch_id="kimi-k2-1t-a32b", config=CONFIG, smoke=SMOKE,
    optimizer="adafactor", grad_accum=16, skip_shapes=FULL_ATTN_SKIP,
)
