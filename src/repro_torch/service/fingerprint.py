"""Dataset fingerprinting for the service layer (DESIGN.md §11.1).

The port of the JAX package's ``service/fingerprint.py``, giving the same
hex string for the same table.  A fingerprint is a SHA-256 content hash of
the *factorized* dataset — the integer ``codes`` matrix, the per-column
``n_bins``, and ``target_col`` — not of the raw float matrix.
Factorization is deterministic, so two byte-identical raw datasets always
factorize to identical codes, and the codes are exactly what the subset
search consumes: datasets that factorize the same have the same search
problem, which is the equivalence the DST cache needs.  Shapes are hashed
explicitly so a prefix relationship between two code buffers can never
collide.

The hash reads the codes on the host (``measures.host_codes``: free for a
dataset on the CPU, one device-to-host copy for one on a card).
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..core.measures import CodedDataset, host_codes

__all__ = ["dataset_fingerprint"]


def dataset_fingerprint(coded: CodedDataset) -> str:
    """Stable hex fingerprint of a factorized dataset."""
    codes, n_bins = host_codes(coded)
    h = hashlib.sha256()
    h.update(np.asarray(codes.shape, np.int64).tobytes())
    h.update(np.ascontiguousarray(codes, dtype=np.int32).tobytes())
    h.update(np.ascontiguousarray(n_bins, dtype=np.int32).tobytes())
    h.update(np.int64(coded.target_col).tobytes())
    return h.hexdigest()
