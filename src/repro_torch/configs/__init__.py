"""Ported-architecture registry: ``--arch <id>`` resolves here.

The dense, ssm and hybrid archs are ported.  whisper-base (encdec),
phi3-vision-4.2b (vlm), qwen2-moe-a2.7b and kimi-k2-1t (moe) are not yet
(ROADMAP A11): ``get_arch`` raises for them.
"""
from __future__ import annotations

from typing import Dict

from . import gemma_2b, granite_3_2b, llama3_405b, mamba2_130m, qwen3_8b, zamba2_2p7b
from .base import ArchDef, smoke_batch

ARCHS: Dict[str, ArchDef] = {
    mod.ARCH.arch_id: mod.ARCH
    for mod in (zamba2_2p7b, qwen3_8b, llama3_405b, gemma_2b, granite_3_2b, mamba2_130m)
}
NOT_PORTED = ("whisper-base", "phi-3-vision-4.2b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b")


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ROADMAP A11)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "NOT_PORTED", "get_arch", "ArchDef", "smoke_batch"]
