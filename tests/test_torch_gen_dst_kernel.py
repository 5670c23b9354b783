"""The fused Gen-DST step of the port (kernels/gen_dst) against the reference.

On the CPU the port's op runs its plain version; it is held to the
reference's ``fused_delta_fitness_ref`` and to its Pallas kernel in
interpret mode.  The CUDA kernel against the plain version is
``tests/test_torch_kernels_card.py``'s (no JAX there, so it runs on a card).

Tolerances: counts bit-equal (exact ±1.0 adds on integer-valued float32);
fitness within 1e-6 absolute (the port sums the entropy in float64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gen_dst.kernel import fused_delta_fitness_pallas
from repro.kernels.gen_dst.ops import fused_delta_fitness as j_fused
from repro.kernels.gen_dst.ref import fused_delta_fitness_ref as j_fused_ref
from repro_torch.kernels.gen_dst.ops import fused_delta_fitness
from _port_cases import FUSED_CASES, fused_args, fused_case, fused_edge_case
from _torch_port import np_


@pytest.mark.parametrize("P,M,B,code_max", FUSED_CASES)
def test_plain_fused_matches_reference(P, M, B, code_max):
    args = fused_case((P,), M, B, seed=P * 131 + B, code_max=code_max)
    c_t, f_t = fused_delta_fitness(*fused_args(args))
    jargs = tuple(jnp.asarray(a) for a in args)
    c_r, f_r = j_fused_ref(*jargs)
    c_k, f_k = fused_delta_fitness_pallas(*jargs, bins=B, interpret=True)
    np.testing.assert_array_equal(np_(c_t), np.asarray(c_r))
    np.testing.assert_array_equal(np_(c_t), np.asarray(c_k))
    np.testing.assert_allclose(np_(f_t), np.asarray(f_r), atol=1e-6)
    np.testing.assert_allclose(np_(f_t), np.asarray(f_k), atol=1e-6)
    if code_max is not None:
        assert not np_(c_t)[..., code_max:].any()


def test_zero_delta_leaves_counts_and_reduces_fitness():
    counts, old, new, _, cm, f_ref = fused_case((6,), 4, 16, seed=9)
    args = (counts, old, new, np.zeros(6, bool), cm, f_ref)
    c_t, f_t = fused_delta_fitness(*fused_args(args))
    np.testing.assert_array_equal(np_(c_t), counts)
    _, f_r = j_fused_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(np_(f_t), np.asarray(f_r), atol=1e-6)


def test_leading_axes_flatten_and_restore_in_place():
    args = fused_case((2, 5), 3, 16, seed=4)
    ported = fused_args(args)
    c_t, f_t = fused_delta_fitness(*ported)
    assert c_t is ported[0], "counts are updated in place"
    assert f_t.shape == (2, 5) and c_t.shape == (2, 5, 3, 16)
    c_r, f_r = j_fused(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(np_(c_t), np.asarray(c_r))
    np.testing.assert_allclose(np_(f_t), np.asarray(f_r), atol=1e-6)


# the card's case is tests/test_torch_kernels_card.py's
@pytest.mark.parametrize("device", ["cpu"])
def test_fused_op_takes_strided_inputs(device):
    """Codes, a bool delta and a column mask given as strided views: the same
    counts and fitness as from contiguous inputs."""
    counts, old, new, applied, cm, f_ref = fused_args(fused_case((7,), 5, 16, seed=3), device)
    c_1, f_1 = fused_delta_fitness(counts.clone(), old, new, applied, cm, f_ref)
    strided = [torch.stack([x, x], dim=-1)[..., 0] for x in (old, new, applied, cm)]
    assert not any(x.is_contiguous() for x in strided)
    c_2, f_2 = fused_delta_fitness(counts.clone(), *strided, f_ref)
    assert torch.equal(c_1, c_2) and torch.equal(f_1, f_2)


@pytest.mark.parametrize("P,M,B", [(6, 23, 256), (9, 5, 13)])
def test_plain_fused_fractional_matches_reference(P, M, B):
    """Fractional counts and delta: the plain version against the reference."""
    args = fused_edge_case(P, M, B, seed=P * M, fractional=True)
    c_t, f_t = fused_delta_fitness(*fused_args(args))
    c_r, f_r = j_fused_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(np_(c_t), np.asarray(c_r))
    np.testing.assert_allclose(np_(f_t), np.asarray(f_r), atol=1e-6)


# the card's case is tests/test_torch_kernels_card.py's
@pytest.mark.parametrize("device", ["cpu"])
def test_fused_f_ref_per_candidate(device):
    """One F(D) per candidate, in the candidates' leading shape (as several
    datasets' searches pass it): each candidate's fitness is the one it gets
    with its own F(D) as the single value, against the reference candidate
    by candidate.  Counts bit-equal, fitness within 1e-6."""
    counts, old, new, applied, cm, _ = fused_case((3, 4), 5, 16, seed=12)
    f_ref = (np.random.default_rng(12).random((3, 4)) * 3.0).astype(np.float32)
    args = fused_args((counts, old, new, applied, cm, f_ref), device)
    c_t, f_t = fused_delta_fitness(*args)
    assert f_t.shape == (3, 4)
    for idx in np.ndindex(3, 4):
        one = (counts[idx][None], old[idx][None], new[idx][None], applied[idx][None],
               cm[idx][None], f_ref[idx])
        c_r, f_r = j_fused_ref(*(jnp.asarray(a) for a in one))
        np.testing.assert_array_equal(np_(c_t)[idx], np.asarray(c_r)[0])
        np.testing.assert_allclose(np_(f_t)[idx], np.asarray(f_r)[0], atol=1e-6)
