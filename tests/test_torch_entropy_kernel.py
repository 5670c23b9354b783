"""The masked histogram of the port (kernels/entropy) against the reference.

On the CPU the port's ops run its plain version; it is held to the
reference's ``masked_histogram_ref`` and to its Pallas kernel in interpret
mode.  The CUDA kernel against the plain version is
``tests/test_torch_kernels_card.py``'s (no JAX there, so it runs on a card).

The gathered entry (``population_histogram_rows``: the row gather done in
the kernel) is held to the reference's ``population_histogram`` on
``codes[rows]``.

Tolerances: 0/1 weights bit-identical; fractional weights rtol = atol =
1e-5 (float32 sums in another order); entropies 1e-6 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.entropy.kernel import masked_histogram_pallas
from repro.kernels.entropy.ops import population_histogram as j_population_histogram
from repro.kernels.entropy.ref import entropy_from_hist as j_entropy_from_hist
from repro.kernels.entropy.ref import masked_histogram_ref as j_hist_ref
from repro_torch.kernels.entropy.kernel import tile_for
from repro_torch.kernels.entropy.ops import (
    column_entropy_masked, masked_histogram, population_histogram, population_histogram_rows,
)
from _port_cases import (GATHERED_SHAPES, PADDING_EDGE_SHAPES, gathered_case, hist_case,
                         strided)
from _torch_port import np_, t


@pytest.mark.parametrize("N,M,B,code_max", PADDING_EDGE_SHAPES)
def test_plain_histogram_matches_reference(N, M, B, code_max):
    codes, w_frac, w_01 = hist_case(N, M, B, code_max, seed=N * 7 + M)
    for w in (w_01, np.ones(N, np.float32)):
        h = np_(masked_histogram(t(codes), t(w), B))
        np.testing.assert_array_equal(h, np.asarray(j_hist_ref(jnp.asarray(codes), jnp.asarray(w), B)))
        np.testing.assert_array_equal(
            h, np.asarray(masked_histogram_pallas(jnp.asarray(codes), jnp.asarray(w), B,
                                                  interpret=True)))
    h = np_(masked_histogram(t(codes), t(w_frac), B))
    np.testing.assert_allclose(h, np.asarray(j_hist_ref(jnp.asarray(codes), jnp.asarray(w_frac), B)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        h, np.asarray(masked_histogram_pallas(jnp.asarray(codes), jnp.asarray(w_frac), B,
                                              interpret=True)), rtol=1e-5, atol=1e-5)
    if code_max is not None:
        assert not h[:, code_max:].any(), "bins no code reaches must stay empty"


def test_column_entropy_masked_matches_reference():
    codes, w_frac, w_01 = hist_case(300, 5, 8, None, seed=3)
    for w in (w_01, w_frac):
        ref = j_entropy_from_hist(j_hist_ref(jnp.asarray(codes), jnp.asarray(w), 8))
        np.testing.assert_allclose(np_(column_entropy_masked(t(codes), t(w), 8)),
                                   np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("P,n,M,B", [(4, 9, 3, 8), (7, 20, 5, 32)])
def test_population_histogram_folds_like_reference(P, n, M, B):
    rng = np.random.default_rng(P * n)
    sub = rng.integers(0, B, (P, n, M)).astype(np.int32)
    h = np_(population_histogram(t(sub), B))
    assert h.shape == (P, M, B)
    np.testing.assert_array_equal(h, np.asarray(j_population_histogram(jnp.asarray(sub), B)))
    np.testing.assert_array_equal(
        h, np.asarray(j_population_histogram(jnp.asarray(sub), B, backend="pallas",
                                             interpret=True)))


@pytest.mark.parametrize("P,n,N,M,B,code_max", GATHERED_SHAPES)
def test_gathered_histogram_matches_reference(P, n, N, M, B, code_max):
    codes, rows = gathered_case(P, n, N, M, B, code_max, seed=P * 17 + M)
    h = np_(population_histogram_rows(t(codes), t(rows), B))
    assert h.shape == (P, M, B)
    ref = np.asarray(j_population_histogram(jnp.asarray(codes[rows]), B))
    np.testing.assert_array_equal(h, ref)
    np.testing.assert_array_equal(h, np_(population_histogram(t(codes[rows]), B)))
    if code_max is not None:
        assert not h[..., code_max:].any(), "bins no code reaches must stay empty"


def test_gathered_histogram_matches_pallas_interpret():
    codes, rows = gathered_case(5, 12, 40, 6, 16, None, seed=5)
    h = np_(population_histogram_rows(t(codes), t(rows), 16))
    np.testing.assert_array_equal(
        h, np.asarray(j_population_histogram(jnp.asarray(codes[rows]), 16, backend="pallas",
                                             interpret=True)))


def test_gathered_histogram_takes_int64_rows_on_the_cpu():
    codes, rows = gathered_case(6, 10, 25, 4, 8, None, seed=8)
    np.testing.assert_array_equal(np_(population_histogram_rows(t(codes), t(rows), 8)),
                                  np_(population_histogram_rows(t(codes), t(rows.astype(np.int64)),
                                                                8)))


# the card's case is tests/test_torch_kernels_card.py's
@pytest.mark.parametrize("device", ["cpu"])
def test_gathered_histogram_takes_int64_and_strided_inputs(device):
    """The op takes int64 rows, and codes and rows that are strided views."""
    codes, rows = gathered_case(6, 10, 25, 4, 8, None, seed=8)
    c, r = t(codes, device=device), t(rows, device=device)
    want = population_histogram_rows(c, r, 8)
    for c_in, r_in in ((c, r.long()), (strided(c), r), (c, strided(r)),
                       (strided(c), strided(r.long()))):
        assert torch.equal(population_histogram_rows(c_in, r_in, 8), want)


def test_gathered_histogram_raises_on_a_row_outside_the_table_on_the_cpu():
    codes, rows = gathered_case(3, 5, 25, 4, 8, None, seed=3)
    rows[1, 2] = 25
    with pytest.raises(IndexError):
        population_histogram_rows(t(codes), t(rows), 8)


@pytest.mark.parametrize("bins", [1, 8, 256, 5000, 20000])
@pytest.mark.parametrize("weighted", [False, True])
def test_tile_fits_shared_memory(bins, weighted):
    """The launch tile: a power of two up to 8 (16 with weights) whose 32-bit
    counts, rows of bins (bins | 1 with weights), fit 48 KB, or one column
    under the 227 KB opt-in."""
    tile = tile_for(bins, weighted)
    assert tile in ((1, 2, 4, 8, 16) if weighted else (1, 2, 4, 8))
    row = 4 * ((bins | 1) if weighted else bins)
    assert tile * row <= 48 * 1024 or (tile == 1 and row <= 232448)


@pytest.mark.parametrize("weighted", [False, True])
def test_tile_refuses_bins_beyond_shared_memory(weighted):
    with pytest.raises(ValueError, match="does not fit"):
        tile_for(60000, weighted)
