"""``repro_torch.core.measures`` against ``repro.core.measures`` on the CPU.

Tolerances: factorize, counts and histograms bit-identical (integer data);
entropies within 1e-6 absolute (the port sums in float64, the reference in
float32); the values-based measures within rtol 1e-5 (float32 reductions in
another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.measures as J
import repro_torch.core.measures as T
from _factorize_cases import CASES, tables
from _torch_port import np_, t


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    N = 700
    X = np.column_stack([
        rng.integers(0, 3, N), rng.integers(0, 40, N),        # categorical
        rng.normal(0, 1, N), rng.exponential(2.0, N),         # continuous, binned
        rng.integers(0, 70, N),                               # > 64 uniques: binned
    ]).astype(np.float32)
    y = rng.integers(0, 3, N)
    return X, y


@pytest.fixture(scope="module")
def coded(data):
    X, y = data
    return J.factorize(X, y, max_bins=32), T.factorize(X, y, max_bins=32, device="cpu")


def test_factorize_bit_identical(data):
    X, y = data
    for kw in ({}, {"max_bins": 16, "categorical_threshold": 8}):
        cj, ct = J.factorize(X, y, **kw), T.factorize(X, y, device="cpu", **kw)
        np.testing.assert_array_equal(np_(ct.codes), np.asarray(cj.codes))
        np.testing.assert_array_equal(np_(ct.values), np.asarray(cj.values))
        np.testing.assert_array_equal(np_(ct.n_bins), np.asarray(cj.n_bins))
        assert (ct.max_bins, ct.target_col) == (cj.max_bins, cj.target_col)
        assert ct.codes.dtype == torch.int32
    cj, ct = J.factorize(X), T.factorize(X, device="cpu")          # no target
    np.testing.assert_array_equal(np_(ct.codes), np.asarray(cj.codes))
    assert ct.target_col == cj.target_col


def test_coded_from_numpy_carries_the_reference(coded):
    from repro_torch.convert import coded_from_numpy
    cj, ct = coded
    cc = coded_from_numpy(np.asarray(cj.codes), np.asarray(cj.values), np.asarray(cj.n_bins),
                          cj.target_col, cj.max_bins, device="cpu")
    for a, b in zip(cc[:3], ct[:3]):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert (cc.target_col, cc.max_bins) == (ct.target_col, ct.max_bins)


def test_counts_and_entropies(coded):
    cj, ct = coded
    B = cj.max_bins
    rng = np.random.default_rng(3)
    w = rng.random(cj.num_rows).astype(np.float32)
    np.testing.assert_array_equal(np_(T.column_counts(ct.codes, B)),
                                  np.asarray(J.column_counts(cj.codes, B)))
    np.testing.assert_allclose(np_(T.column_counts(ct.codes, B, t(w))),
                               np.asarray(J.column_counts(cj.codes, B, jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np_(T.column_entropy(ct.codes, B)),
                               np.asarray(J.column_entropy(cj.codes, B)), atol=1e-6)
    # chunking: a chunk smaller than N must not change the result
    np.testing.assert_allclose(np_(T.full_column_entropy(ct.codes, B, chunk=128)),
                               np.asarray(J.full_column_entropy(cj.codes, B)), atol=1e-6)
    mask = np.arange(cj.num_cols) % 2 == 0
    for cm in (None, mask):
        np.testing.assert_allclose(
            float(T.dataset_entropy(ct.codes, B, None if cm is None else t(cm))),
            float(J.dataset_entropy(cj.codes, B, None if cm is None else jnp.asarray(cm))),
            atol=1e-6)


def test_entropy_clamps_on_empty_and_padding_bins():
    counts = np.zeros((3, 8), np.float32)
    counts[1, 2] = 5.0
    counts[2, :3] = [1.0, 2.0, 1.0]
    np.testing.assert_allclose(np_(T.column_entropy_from_counts(t(counts))),
                               np.asarray(J.column_entropy_from_counts(jnp.asarray(counts))),
                               atol=1e-6)
    assert np_(T.column_entropy_from_counts(t(counts)))[0] == 0.0


def test_subset_counts_and_entropy(coded):
    cj, ct = coded
    B = cj.max_bins
    rng = np.random.default_rng(5)
    rows = rng.integers(0, cj.num_rows, 40).astype(np.int32)
    mask = rng.random(cj.num_cols) < 0.5
    mask[cj.target_col] = True
    np.testing.assert_array_equal(np_(T.subset_counts(ct.codes, t(rows), B)),
                                  np.asarray(J.subset_counts(cj.codes, jnp.asarray(rows), B)))
    np.testing.assert_allclose(
        float(T.subset_entropy(ct.codes, t(rows), t(mask), B)),
        float(J.subset_entropy(cj.codes, jnp.asarray(rows), jnp.asarray(mask), B)), atol=1e-6)


@pytest.mark.parametrize("name", ["pnorm", "mean_correlation", "coeff_variation"])
def test_values_measures(coded, name):
    cj, ct = coded
    fj, ft = J.MEASURES[name], T.MEASURES[name]
    rng = np.random.default_rng(7)
    rows = rng.integers(0, cj.num_rows, (3, 30)).astype(np.int32)
    masks = rng.random((3, cj.num_cols)) < 0.6
    np.testing.assert_allclose(float(ft(ct.values)), float(fj(cj.values)), rtol=1e-5)
    # registry contract: col_mask=None means every column
    np.testing.assert_allclose(float(ft(ct.values, t(rows[0]))),
                               float(fj(cj.values, jnp.asarray(rows[0]))), rtol=1e-5)
    batched = np_(ft(ct.values, t(rows), t(masks)))       # the port takes a batch axis
    for i in range(3):
        ref = float(fj(cj.values, jnp.asarray(rows[i]), jnp.asarray(masks[i])))
        np.testing.assert_allclose(batched[i], ref, rtol=1e-5, atol=1e-7)
    assert T.MEASURES["entropy"] is None


@pytest.mark.parametrize("case", list(CASES))
def test_factorize_bit_identical_on_edge_tables(case):
    """The batched factorize against the reference's per-column NumPy loop:
    codes, values, n_bins, max_bins and target_col equal bit for bit."""
    for X, y, kw in tables(case):
        cj, ct = J.factorize(X, y, **kw), T.factorize(X, y, device="cpu", **kw)
        np.testing.assert_array_equal(np_(ct.codes), np.asarray(cj.codes))
        np.testing.assert_array_equal(np_(ct.values), np.asarray(cj.values))
        np.testing.assert_array_equal(np_(ct.n_bins), np.asarray(cj.n_bins))
        assert (ct.max_bins, ct.target_col) == (cj.max_bins, cj.target_col)
        assert (ct.codes.dtype, ct.n_bins.dtype, ct.values.dtype) == (
            torch.int32, torch.int32, torch.float32)
