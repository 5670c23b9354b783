"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared.  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

60 experts % 16 != 0, so EP falls back to TP inside experts (the expert
``mlp`` axis shards over model — see DESIGN.md §6 / sharding sanitizer).
"""
from ..models.config import ModelConfig
from .base import ArchDef, FULL_ATTN_SKIP

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408,
    vocab_size=151936,
    n_experts=60, n_shared_experts=4, moe_top_k=4, capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe",
    n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=32,
    vocab_size=512,
    n_experts=8, n_shared_experts=2, moe_top_k=2, capacity_factor=1.25,
)

ARCH = ArchDef(
    arch_id="qwen2-moe-a2.7b", config=CONFIG, smoke=SMOKE,
    # deeper accumulation bounds the (E, C, D) dispatch buffers (60 experts
    # don't shard over the 16-wide model axis => buffers replicate)
    optimizer="adamw", grad_accum=8, skip_shapes=FULL_ATTN_SKIP,
)
