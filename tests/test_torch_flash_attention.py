"""The flash-attention kernel of the port (kernels/flash_attention) against
the reference.

On the CPU the port's op runs its plain version; it is held to the
reference's ``attention_ref`` and to its Pallas kernel in interpret mode.
The CUDA leg compares the hand-written kernel with the plain version and
skips without a card.

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
from _torch_port import np_, requires_cuda, skip_without_cuda

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, Sq, Skv, H, Kh, hd, causal, dtype): GQA, MQA, MHA; hd 16, 20, 32
CASES = [
    (2, 64, 64, 4, 2, 16, True, "float32"),
    (1, 64, 64, 4, 1, 32, True, "float32"),
    (2, 64, 64, 4, 4, 20, True, "float32"),
    (2, 64, 64, 4, 2, 32, False, "float32"),
    (1, 64, 64, 8, 1, 20, False, "float32"),
    (2, 64, 64, 4, 2, 16, True, "bfloat16"),
    (1, 64, 64, 4, 1, 32, False, "bfloat16"),
]


def _inputs(B, Sq, Skv, H, Kh, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, H, hd)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Kh, hd)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Kh, hd)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Skv,H,Kh,hd,causal,dtype", CASES)
def test_plain_matches_reference_and_pallas(B, Sq, Skv, H, Kh, hd, causal, dtype):
    q, k, v = _inputs(B, Sq, Skv, H, Kh, hd, seed=Sq + H + hd)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in (q, k, v))
    o = flash_attention(tq, tk, tv, causal=causal)
    assert o.dtype == getattr(torch, dtype) and o.shape == (B, Sq, H, hd)
    o = np_(o)
    np.testing.assert_allclose(o, np.asarray(j_attention_ref(jq, jk, jv, causal=causal),
                                             np.float32), atol=TOL[dtype], rtol=0)
    o_pallas = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                                      interpret=True)
    np.testing.assert_allclose(o, np.asarray(o_pallas, np.float32), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("Sq,Skv,causal", [(50, 50, True), (37, 70, True), (70, 37, False)])
def test_plain_takes_ragged_lengths(Sq, Skv, causal):
    """Lengths that are no multiple of any tile (the kernel masks its tails)."""
    q, k, v = _inputs(2, Sq, Skv, 4, 2, 16, seed=Sq * Skv)
    o = np_(attention_ref(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal))
    ref = j_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(o, np.asarray(ref), atol=2e-5, rtol=0)


def test_causal_row_zero_attends_only_key_zero():
    q, k, v = (torch.as_tensor(a) for a in _inputs(1, 64, 64, 2, 2, 16, seed=0))
    o = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(np_(o[0, 0]), np_(v[0, 0]), atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)


@requires_cuda
@pytest.mark.parametrize("B,Sq,Skv,H,Kh,hd,causal,dtype", CASES + [
    (2, 300, 300, 32, 32, 80, True, "bfloat16"),
    (1, 200, 333, 8, 1, 256, True, "float32"),
    (2, 128, 128, 32, 8, 128, False, "bfloat16"),
    (3, 200, 200, 32, 32, 80, True, "bfloat16"),    # hd 80, Sq no multiple of 128
    (2, 200, 333, 8, 2, 80, False, "bfloat16"),     # Skv > Sq, non-causal
    (2, 333, 333, 8, 1, 256, True, "bfloat16"),     # MQA, hd 256, ragged
    (2, 70, 70, 4, 2, 20, True, "bfloat16"),        # hd 20: the wrapper pads it
])
def test_cuda_kernel_matches_plain(B, Sq, Skv, H, Kh, hd, causal, dtype):
    skip_without_cuda()
    q, k, v = (torch.as_tensor(a, device="cuda").to(getattr(torch, dtype))
               for a in _inputs(B, Sq, Skv, H, Kh, hd, seed=1))
    o_k = flash_attention_cuda(q, k, v, causal=causal)
    o_r = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (o_k.float() - o_r.float()).abs().max().item() <= TOL[dtype]
