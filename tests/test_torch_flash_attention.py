"""The flash-attention kernel of the port (kernels/flash_attention) against
the reference.

On the CPU the port's op runs its plain version; it is held to the
reference's ``attention_ref`` and to its Pallas kernel in interpret mode.
The CUDA kernel against the plain version is
``tests/test_torch_kernels_card.py``'s (no JAX there, so it runs on a card).

Tolerances (max-abs, as ``tests/test_kernels.py:145``): float32 2e-5;
bfloat16 2e-2 (one bf16 rounding of outputs of magnitude ~1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from _port_cases import FA_CASES, FA_TOL, fa_inputs
from _torch_port import np_


@pytest.mark.parametrize("B,Sq,Skv,H,Kh,hd,causal,dtype", FA_CASES)
def test_plain_matches_reference_and_pallas(B, Sq, Skv, H, Kh, hd, causal, dtype):
    q, k, v = fa_inputs(B, Sq, Skv, H, Kh, hd, seed=Sq + H + hd)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal)
    assert o.dtype == getattr(torch, dtype) and o.shape == (B, Sq, H, hd)
    o = np_(o)
    np.testing.assert_allclose(o, np.asarray(j_attention_ref(jq, jk, jv, causal=causal),
                                             np.float32), atol=FA_TOL[dtype], rtol=0)
    o_pallas = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                                      interpret=True)
    np.testing.assert_allclose(o, np.asarray(o_pallas, np.float32), atol=FA_TOL[dtype], rtol=0)


@pytest.mark.parametrize("Sq,Skv,causal", [(50, 50, True), (37, 70, True), (70, 37, False)])
def test_plain_takes_ragged_lengths(Sq, Skv, causal):
    """Lengths that are no multiple of any tile (the kernel masks its tails)."""
    q, k, v = fa_inputs(2, Sq, Skv, 4, 2, 16, seed=Sq * Skv)
    o = np_(attention_ref(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal))
    ref = j_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(o, np.asarray(ref), atol=2e-5, rtol=0)


def test_causal_row_zero_attends_only_key_zero():
    q, k, v = (torch.as_tensor(a) for a in fa_inputs(1, 64, 64, 2, 2, 16, seed=0))
    o = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(np_(o[0, 0]), np_(v[0, 0]), atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
