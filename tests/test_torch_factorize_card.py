"""``factorize`` on a CUDA card against the same function on the CPU and
against the per-column NumPy loop, on every table of ``_factorize_cases``.
The port alone, no JAX, so it runs on the card machine; skips without a card.

Tolerances: none (codes, values and bin counts are equal).
"""
import numpy as np
import pytest
import torch

from _factorize_cases import CASES, numpy_factorize, tables
from repro_torch.core.measures import factorize


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_card_codes_equal_the_cpu_codes(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the card's codes with the CPU's")
    for X, y, kw in tables(case):
        card, cpu = factorize(X, y, device="cuda", **kw), factorize(X, y, device="cpu", **kw)
        for a, b in zip(card[:3], cpu[:3]):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0, equal_nan=True)
        assert (card.target_col, card.max_bins) == (cpu.target_col, cpu.max_bins)
        codes, n_bins, max_bins = numpy_factorize(X, y, **kw)
        np.testing.assert_array_equal(card.codes.cpu().numpy(), codes)
        np.testing.assert_array_equal(card.n_bins.cpu().numpy(), n_bins)
        assert card.max_bins == max_bins
