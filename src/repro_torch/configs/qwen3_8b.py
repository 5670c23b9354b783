"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, FULL_ATTN_SKIP

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=12288,
    vocab_size=151936, qk_norm=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, qk_norm=True,
)

ARCH = ArchDef(
    arch_id="qwen3-8b", config=CONFIG, smoke=SMOKE,
    optimizer="adamw", grad_accum=4, skip_shapes=FULL_ATTN_SKIP,
)
