"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend (stubbed: input_specs
supplies patch embeddings).  [hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
from ..models.config import ModelConfig
from .base import ArchDef, FULL_ATTN_SKIP

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, head_dim=96, d_ff=8192,
    vocab_size=32064, n_img_tokens=256,
)

SMOKE = ModelConfig(
    name="phi3v-smoke", family="vlm",
    n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512, n_img_tokens=8,
)

ARCH = ArchDef(
    arch_id="phi-3-vision-4.2b", config=CONFIG, smoke=SMOKE,
    optimizer="adamw", grad_accum=4, skip_shapes=FULL_ATTN_SKIP,
)
