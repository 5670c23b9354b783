"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
GeGLU, head_dim=256, MQA.  [arXiv:2403.08295; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, FULL_ATTN_SKIP

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384,
    vocab_size=256000, act="gelu", glu=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=1, head_dim=32, d_ff=128,
    vocab_size=512, act="gelu", glu=True, tie_embeddings=True,
)

ARCH = ArchDef(
    arch_id="gemma-2b", config=CONFIG, smoke=SMOKE,
    optimizer="adamw", grad_accum=4, skip_shapes=FULL_ATTN_SKIP,
)
