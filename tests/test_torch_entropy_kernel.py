"""The masked histogram of the port (kernels/entropy) against the reference.

On the CPU the port's ops run its plain version; it is held to the
reference's ``masked_histogram_ref`` and to its Pallas kernel in interpret
mode.  The CUDA leg compares the hand-written kernel with the plain version
and skips without a card.

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
from repro_torch.kernels.entropy.ops import (
    column_entropy_masked, masked_histogram, population_histogram,
)
from repro_torch.kernels.entropy.ref import masked_histogram_ref
from _torch_port import np_, requires_cuda, skip_without_cuda, t

# the reference's padding edges (tests/test_kernels.py): rows shorter than a
# tile, a ragged column tile, and bins beyond every code
PADDING_EDGE_SHAPES = [
    (5, 3, 8, None),
    (300, 13, 16, None),
    (200, 4, 64, 11),
    (7, 9, 32, 5),
]


def _case(N, M, B, code_max, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B if code_max is None else code_max, (N, M)).astype(np.int32)
    return codes, rng.random(N).astype(np.float32), (rng.random(N) < 0.5).astype(np.float32)


@pytest.mark.parametrize("N,M,B,code_max", PADDING_EDGE_SHAPES)
def test_plain_histogram_matches_reference(N, M, B, code_max):
    codes, w_frac, w_01 = _case(N, M, B, code_max, seed=N * 7 + M)
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
    codes, w_frac, w_01 = _case(300, 5, 8, None, seed=3)
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


@requires_cuda
@pytest.mark.parametrize("N,M,B,code_max", PADDING_EDGE_SHAPES + [(322, 2300, 256, None)])
def test_cuda_histogram_matches_plain(N, M, B, code_max):
    skip_without_cuda()
    codes, w_frac, w_01 = _case(N, M, B, code_max, seed=N + M)
    c = t(codes, device="cuda")
    for w in (w_01, np.ones(N, np.float32)):
        wt = t(w, device="cuda")
        assert torch.equal(masked_histogram(c, wt, B), masked_histogram_ref(c, wt, B))
    wt = t(w_frac, device="cuda")
    torch.testing.assert_close(masked_histogram(c, wt, B), masked_histogram_ref(c, wt, B),
                               rtol=1e-5, atol=1e-5)
