"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155.  [hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, FULL_ATTN_SKIP

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192,
    vocab_size=49155, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=512, tie_embeddings=True,
)

ARCH = ArchDef(
    arch_id="granite-3-2b", config=CONFIG, smoke=SMOKE,
    # vocab 49155 is not 16-divisible => logits replicate over model; the
    # deeper accumulation keeps per-microbatch logits ~1.6 GB/dev.
    optimizer="adamw", grad_accum=8, skip_shapes=FULL_ATTN_SKIP,
)
