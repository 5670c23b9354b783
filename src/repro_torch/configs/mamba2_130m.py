"""mamba2-130m [ssm]: 24L d_model=768 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

Attention-free => long_500k runs (state is O(1) per token).
"""
from ..models.config import ModelConfig
from .base import ArchDef

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768,
    vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64,
    vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    tie_embeddings=True,
)

ARCH = ArchDef(
    arch_id="mamba2-130m", config=CONFIG, smoke=SMOKE,
    optimizer="adamw", grad_accum=1,
    # 24 ssm heads don't divide the 16-wide model axis — the model axis joins
    # the batch axes instead (pure DP; 130M params replicate comfortably).
    dp_over_model=True,
)
