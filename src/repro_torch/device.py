"""Device resolution for the port's entry points, and the resources its
CUDA graph captures share.

Every entry point takes ``device=``; ``None`` means ``"cuda"``.  Asking for
CUDA on a machine without a card raises: the port never drops to the CPU
on its own.  The CPU runs only when the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "make_generator", "capture_resources"]

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


# A side stream to capture on (the legacy default stream cannot capture) and
# one memory pool that every capture of the thread shares: the graphed Adam
# steps (``automl/models.adam_train``) and the graphed Gen-DST generations
# (``core/gen_dst``).  A graph lives for one call, and the next call's
# capture reuses its blocks rather than allocating a pool of its own.  The
# pool is the one of a graph of one fill captured once and never replayed: a
# pool whose last graph is freed cannot take another capture.  So the pool
# lives as long as its thread and keeps the segments of the largest graph
# the thread ever captured, which eager allocations cannot use.  Per thread:
# two captures must never run at once on one stream or into one pool.
_CAPTURE = threading.local()


def capture_resources(dev: torch.device):
    """(side stream, graph holding the shared pool) of this thread on ``dev``."""
    per_dev = getattr(_CAPTURE, "per_dev", None)
    if per_dev is None:
        per_dev = _CAPTURE.per_dev = {}
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in per_dev:
        with torch.cuda.device(key):
            side, holder = torch.cuda.Stream(), torch.cuda.CUDAGraph()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                holder.capture_begin(capture_error_mode="thread_local")
                try:
                    torch.zeros((1,), device=dev)
                finally:
                    holder.capture_end()
        per_dev[key] = (side, holder)
    return per_dev[key]
