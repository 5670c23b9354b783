"""The fused Gen-DST step of the port (kernels/gen_dst) against the reference.

On the CPU the port's op runs its plain version; it is held to the
reference's ``fused_delta_fitness_ref`` and to its Pallas kernel in
interpret mode.  The CUDA leg compares the hand-written kernel with the
plain version and skips without a card.

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
from repro_torch.kernels.gen_dst.kernel import fused_delta_fitness_cuda
from repro_torch.kernels.gen_dst.ops import fused_delta_fitness
from repro_torch.kernels.gen_dst.ref import fused_delta_fitness_ref
from _torch_port import np_, requires_cuda, skip_without_cuda, t


def _case(lead, M, B, seed, code_max=None):
    """Random inputs with leading shape ``lead``; ``code_max`` < B leaves
    padding bins."""
    rng = np.random.default_rng(seed)
    hi = B if code_max is None else code_max
    base = rng.integers(0, hi, lead + (12, M))
    counts = np.zeros(lead + (M, B), np.float32)
    for idx in np.ndindex(*lead):
        for j in range(M):
            np.add.at(counts[idx + (j,)], base[idx + (slice(None), j)], 1.0)
    old = base[..., 0, :].astype(np.int32)
    new = rng.integers(0, hi, lead + (M,)).astype(np.int32)
    applied = rng.random(lead) < 0.6
    col_mask = rng.random(lead + (M,)) < 0.5
    col_mask[..., 0] = True
    return counts, old, new, applied, col_mask, np.float32(rng.random() * 3.0)


# the reference's cases (tests/test_gen_dst_fused.py): P below, above and at
# the Pallas tile, and padding bins
FUSED_CASES = [
    (3, 4, 8, None),
    (10, 5, 16, None),
    (16, 3, 32, 17),
    (8, 7, 8, None),
    (25, 2, 64, 40),
]


def _port(args, device="cpu"):
    counts, old, new, applied, cm, f_ref = args
    return (t(counts, device=device), t(old, device=device), t(new, device=device),
            t(applied, device=device), t(cm, device=device), t(f_ref, device=device))


@pytest.mark.parametrize("P,M,B,code_max", FUSED_CASES)
def test_plain_fused_matches_reference(P, M, B, code_max):
    args = _case((P,), M, B, seed=P * 131 + B, code_max=code_max)
    c_t, f_t = fused_delta_fitness(*_port(args))
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
    counts, old, new, _, cm, f_ref = _case((6,), 4, 16, seed=9)
    args = (counts, old, new, np.zeros(6, bool), cm, f_ref)
    c_t, f_t = fused_delta_fitness(*_port(args))
    np.testing.assert_array_equal(np_(c_t), counts)
    _, f_r = j_fused_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(np_(f_t), np.asarray(f_r), atol=1e-6)


def test_leading_axes_flatten_and_restore_in_place():
    args = _case((2, 5), 3, 16, seed=4)
    ported = _port(args)
    c_t, f_t = fused_delta_fitness(*ported)
    assert c_t is ported[0], "counts are updated in place"
    assert f_t.shape == (2, 5) and c_t.shape == (2, 5, 3, 16)
    c_r, f_r = j_fused(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(np_(c_t), np.asarray(c_r))
    np.testing.assert_allclose(np_(f_t), np.asarray(f_r), atol=1e-6)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=requires_cuda)])
def test_fused_op_takes_strided_inputs(device):
    """Codes, a bool delta and a column mask given as strided views: the same
    counts and fitness as from contiguous inputs, on the card as on the CPU."""
    if device == "cuda":
        skip_without_cuda()
    counts, old, new, applied, cm, f_ref = _port(_case((7,), 5, 16, seed=3), device)
    c_1, f_1 = fused_delta_fitness(counts.clone(), old, new, applied, cm, f_ref)
    strided = [torch.stack([x, x], dim=-1)[..., 0] for x in (old, new, applied, cm)]
    assert not any(x.is_contiguous() for x in strided)
    c_2, f_2 = fused_delta_fitness(counts.clone(), *strided, f_ref)
    assert torch.equal(c_1, c_2) and torch.equal(f_1, f_2)


@requires_cuda
@pytest.mark.parametrize("P,M,B,code_max", FUSED_CASES + [(100, 23, 256, None)])
def test_cuda_fused_matches_plain(P, M, B, code_max):
    skip_without_cuda()
    args = _case((P,), M, B, seed=P + M, code_max=code_max)
    c_k, f_k = fused_delta_fitness(*_port(args, "cuda"))
    c_r, f_r = fused_delta_fitness_ref(*_port(args, "cuda"))
    assert torch.equal(c_k, c_r)
    assert (f_k - f_r).abs().max().item() <= 1e-6


def _edge_case(P, M, B, seed, fractional):
    """Counts and delta, integer-valued or fractional (with empty bins)."""
    rng = np.random.default_rng(seed)
    if fractional:
        counts = rng.random((P, M, B)) * 4 * (rng.random((P, M, B)) < 0.6)
        applied = rng.random(P)
    else:
        counts = rng.integers(0, 40, (P, M, B)) * (rng.random((P, M, B)) < 0.3)
        applied = rng.random(P) < 0.6
    old = rng.integers(0, B, (P, M)).astype(np.int32)
    new = rng.integers(0, B, (P, M)).astype(np.int32)
    col_mask = rng.random((P, M)) < 0.5
    col_mask[:, 0] = True
    return (counts.astype(np.float32), old, new, applied.astype(np.float32), col_mask,
            np.float32(rng.random() * 3.0))


@pytest.mark.parametrize("P,M,B", [(6, 23, 256), (9, 5, 13)])
def test_plain_fused_fractional_matches_reference(P, M, B):
    """Fractional counts and delta: the plain version against the reference."""
    args = _edge_case(P, M, B, seed=P * M, fractional=True)
    c_t, f_t = fused_delta_fitness(*_port(args))
    c_r, f_r = j_fused_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(np_(c_t), np.asarray(c_r))
    np.testing.assert_allclose(np_(f_t), np.asarray(f_r), atol=1e-6)


def _aligned_copy(x, like):
    """A copy of ``x`` at the address of ``like`` modulo 16 bytes."""
    off = (like.data_ptr() % 16) // like.element_size()
    out = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)[off:].view(x.shape)
    return out.copy_(x)


# (label, P, M, B, fractional, view): fractional counts and delta; slabs of
# 100 and 600 columns, more than a CTA's 32 warps; slabs of a size, or at an
# address, no multiple of 16 bytes (scalar loads)
CUDA_EDGES = [
    ("fractional", 50, 23, 256, True, None),
    ("slab over 48 KB", 6, 100, 256, False, None),
    ("slab over 227 KB", 3, 600, 256, False, None),
    ("counts[1:] view", 9, 5, 13, True, "slab"),
    ("one float off alignment", 8, 23, 256, False, "float"),
]


@requires_cuda
@pytest.mark.parametrize("label,P,M,B,fractional,view", CUDA_EDGES,
                         ids=[e[0] for e in CUDA_EDGES])
def test_cuda_fused_edges_match_plain(label, P, M, B, fractional, view):
    skip_without_cuda()
    counts, old, new, applied, cm, f_ref = _port(
        _edge_case(P + (view == "slab"), M, B, seed=P * B, fractional=fractional), "cuda")
    if view == "slab":
        counts, old, new, applied, cm = counts[1:], old[1:], new[1:], applied[1:], cm[1:]
    elif view == "float":
        buf = torch.empty(counts.numel() + 1, device="cuda")
        counts = buf[1:].view(counts.shape).copy_(counts)
    c_r, f_r = fused_delta_fitness_ref(counts.clone(), old, new, applied, cm, f_ref.reshape(1))
    c_k, f_k = fused_delta_fitness_cuda(_aligned_copy(counts, counts), old, new, applied, cm,
                                        f_ref.reshape(1))
    assert torch.equal(c_k, c_r)
    assert (f_k - f_r).abs().max().item() <= 1e-6


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=requires_cuda)])
def test_fused_f_ref_per_candidate(device):
    """One F(D) per candidate, in the candidates' leading shape (as several
    datasets' searches pass it): each candidate's fitness is the one it gets
    with its own F(D) as the single value.  On the CPU against the reference
    candidate by candidate; on the card the kernel against the plain
    version.  Counts bit-equal, fitness within 1e-6."""
    if device == "cuda":
        skip_without_cuda()
    counts, old, new, applied, cm, _ = _case((3, 4), 5, 16, seed=12)
    f_ref = (np.random.default_rng(12).random((3, 4)) * 3.0).astype(np.float32)
    args = _port((counts, old, new, applied, cm, f_ref), device)
    c_t, f_t = fused_delta_fitness(*args)
    assert f_t.shape == (3, 4)
    if device == "cuda":
        c_r, f_r = fused_delta_fitness_ref(*(a.reshape((12,) + a.shape[2:]) for a in
                                             _port((counts, old, new, applied, cm, f_ref),
                                                   device)))
        assert torch.equal(c_t.reshape(c_r.shape), c_r)
        assert (f_t.reshape(-1) - f_r).abs().max().item() <= 1e-6
        with pytest.raises(ValueError, match="f_ref"):
            fused_delta_fitness_cuda(args[0], args[1], args[2], args[3].float(), args[4],
                                     args[5][:2].contiguous())
        return
    for idx in np.ndindex(3, 4):
        one = (counts[idx][None], old[idx][None], new[idx][None], applied[idx][None],
               cm[idx][None], f_ref[idx])
        c_r, f_r = j_fused_ref(*(jnp.asarray(a) for a in one))
        np.testing.assert_array_equal(np_(c_t)[idx], np.asarray(c_r)[0])
        np.testing.assert_allclose(np_(f_t)[idx], np.asarray(f_r)[0], atol=1e-6)
