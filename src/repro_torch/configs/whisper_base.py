"""whisper-base [audio]: 6L d_model=512 8H (GQA kv=8) d_ff=2048 vocab=51865.

Enc-dec; conv audio frontend stubbed (input_specs supplies frame embeddings).
[arXiv:2212.04356; unverified]
"""
from ..models.config import ModelConfig
from .base import ArchDef, FULL_ATTN_SKIP

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048,
    vocab_size=51865, act="gelu", glu=False,
    dec_ratio=8, max_dec_len=4096,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=512, act="gelu", glu=False,
    dec_ratio=8, max_dec_len=64,
)

ARCH = ArchDef(
    arch_id="whisper-base", config=CONFIG, smoke=SMOKE,
    optimizer="adamw", grad_accum=1, skip_shapes=FULL_ATTN_SKIP,
    # 8 heads / d_model 512 don't use a 16-wide TP axis; the 72M-param model
    # replicates trivially => pure DP over all mesh axes.
    dp_over_model=True,
)
