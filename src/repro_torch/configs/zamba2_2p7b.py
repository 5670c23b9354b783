"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks.
[arXiv:2411.15242; hf]

Sub-quadratic backbone => long_500k runs (DESIGN.md §4).
"""
from ..models.config import ModelConfig
from .base import ArchDef

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240,
    vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    shared_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    shared_attn_every=2,
)

ARCH = ArchDef(
    arch_id="zamba2-2.7b", config=CONFIG, smoke=SMOKE,
    optimizer="adamw", grad_accum=8,
)
