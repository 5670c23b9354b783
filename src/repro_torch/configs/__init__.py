"""Architecture registry of the port: ``--arch <id>`` resolves here.

All ten of the JAX package's architectures: dense (qwen3-8b, llama3-405b,
gemma-2b, granite-3-2b), ssm (mamba2-130m), hybrid (zamba2-2.7b), moe
(qwen2-moe-a2.7b, kimi-k2-1t-a32b), vlm (phi-3-vision-4.2b) and encdec
(whisper-base).
"""
from __future__ import annotations

from typing import Dict

from . import (
    gemma_2b, granite_3_2b, kimi_k2_1t, llama3_405b, mamba2_130m, phi3_vision_4p2b,
    qwen2_moe_a2p7b, qwen3_8b, whisper_base, zamba2_2p7b,
)
from .base import ArchDef, decode_operand_specs, input_specs, smoke_batch

ARCHS: Dict[str, ArchDef] = {
    mod.ARCH.arch_id: mod.ARCH
    for mod in (
        whisper_base, zamba2_2p7b, qwen3_8b, llama3_405b, gemma_2b,
        granite_3_2b, phi3_vision_4p2b, mamba2_130m, qwen2_moe_a2p7b,
        kimi_k2_1t,
    )
}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "get_arch", "ArchDef", "smoke_batch", "input_specs", "decode_operand_specs"]
