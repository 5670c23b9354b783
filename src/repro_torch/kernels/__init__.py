"""Hand-written Hopper kernels of the port, each beside its plain version.

Each kernel package holds ``ref.py`` (plain PyTorch), ``kernel.py`` (the
CUDA wrapper and its launch counter) and ``ops.py`` (the public op: a CUDA
tensor launches the kernel, a CPU tensor runs the plain version).
"""
from __future__ import annotations

from .entropy import kernel as _entropy_kernel
from .flash_attention import kernel as _flash_attention_kernel
from .gen_dst import kernel as _gen_dst_kernel
from .ssd_scan import kernel as _ssd_scan_kernel

__all__ = ["GEN_DST_KERNELS", "add_launches", "launch_counts", "reset_launch_counts"]

_KERNELS = {
    "masked_histogram": _entropy_kernel,
    "fused_delta_fitness": _gen_dst_kernel,
    "flash_attention": _flash_attention_kernel,
    "ssd_scan": _ssd_scan_kernel,
}
# Gen-DST's two kernels (B1, B2): every Gen-DST search launches both
GEN_DST_KERNELS = ("masked_histogram", "fused_delta_fitness")


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def add_launches(counts: dict) -> None:
    """Add ``counts`` (kernel name -> launches, may be negative) to the
    counters: a CUDA graph's capture calls the wrappers, which count, but
    launches nothing, and each replay launches what the graph holds."""
    for name, n in counts.items():
        _KERNELS[name].launches += n
