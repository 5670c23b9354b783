"""Device resolution for the port's entry points.

Every entry point takes ``device=``; ``None`` means ``"cuda"``.  Asking for
CUDA on a machine without a card raises: the port never drops to the CPU
on its own.  The CPU runs only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "make_generator"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``, defaulting to CUDA; raises if CUDA
    is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass device='cpu' "
                "to run on the CPU")
        # The GNB and centroid fits and every linear model are float32
        # matmuls: keep them in full float32 (no TF32), as the reference is.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def make_generator(seed: int, device: Optional[torch.device] = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device if device is not None else "cpu")
    gen.manual_seed(int(seed))
    return gen
