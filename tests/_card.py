"""Helpers of the port's tests that import nothing of JAX or of the
reference, so that the ``cuda`` test files (``tests/test_torch_*_card.py``)
that use them can run on a machine with a CUDA card and no JAX.

Run the card files there with ``src`` on the path:

    python -m pytest -q -m cuda tests/test_torch_<layer>_card.py

Every ``cuda`` case decides at run time whether there is a card
(``skip_without_cuda``), never while its module is imported, so the CPU run
collects the same cases in every worker and skips them in milliseconds.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

requires_cuda = pytest.mark.cuda


def skip_without_cuda():
    """Skip the calling test or fixture when no CUDA card is present
    (decided at run time, never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels cannot run on the CPU")


def t(x, dtype=None, device="cpu") -> torch.Tensor:
    """numpy (or JAX) array -> torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def np_(x) -> np.ndarray:
    """torch tensor or array -> numpy (bfloat16 as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


@contextlib.contextmanager
def no_host_sync():
    """Inside the block every operation that waits for the host raises
    (``torch.cuda.set_sync_debug_mode("error")``); the card is synchronised
    before and after."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def plain_fitness(coded, row_idx, cols) -> float:
    """-|H(d) - H(D)| of a subset of the factorized table ``coded``,
    recomputed with the plain entropy: rows ``row_idx``, columns ``cols``
    (indices or a boolean mask) with the target column added."""
    from repro_torch.core.measures import full_column_entropy, subset_entropy
    B, dev = coded.max_bins, coded.codes.device
    mask = torch.zeros(coded.codes.shape[1], dtype=torch.bool, device=dev)
    mask[torch.as_tensor(cols, device=dev)] = True
    mask[coded.target_col] = True
    rows = torch.as_tensor(row_idx, device=dev)
    return -abs(subset_entropy(coded.codes, rows, mask, B).item()
                - full_column_entropy(coded.codes, B).mean().item())


def finite_acc(acc) -> bool:
    """A test accuracy that is a finite number in [0, 1]."""
    return acc is not None and bool(np.isfinite(acc)) and 0.0 <= acc <= 1.0
