"""The SSD-scan kernel of the port (kernels/ssd_scan) against the reference.

On the CPU the port's op runs its plain version (the per-timestep
recurrence, which also returns the final state); it is held to the
reference's ``ssd_scan_ref``, its Pallas kernel in interpret mode, its
model-layout op and the model's chunked form's final state.  The chunked
plain version (the three passes the bfloat16 CUDA body runs) is held to the
same references, so the algebra of the decomposition is tested here.  The
CUDA kernel against the plain version is ``tests/test_torch_kernels_card.py``'s
(no JAX there, so it runs on a card).

Tolerances (max-abs, as ``tests/test_ssd_kernel.py:35``): y 1e-3 in float32,
5e-2 in bfloat16; the final state 1e-3 in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ssd_scan_ref
from repro.models.config import ModelConfig as JModelConfig
from repro.models.ssm import _ssd_chunked
from repro_torch.kernels.ssd_scan.kernel import chunk_for, ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_states, ssd_scan_chunked_ref,
                                              ssd_scan_model_ref, ssd_scan_ref,
                                              ssd_state_passing)
from _port_cases import SSD_TOL, ssd_model_inputs
from _torch_port import np_

# (BH, S, P, N, Q, dtype): the reference's CASES
HEAD_CASES = [
    (2, 32, 8, 16, 8, "float32"),
    (3, 64, 16, 8, 16, "float32"),
    (1, 128, 64, 32, 32, "float32"),
    (2, 64, 16, 16, 16, "bfloat16"),
]


def _head_inputs(BH, S, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (BH, S, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (BH, S)).astype(np.float32),
            -rng.uniform(0.5, 4.0, (BH,)).astype(np.float32),
            rng.normal(0, 1, (BH, S, N)).astype(np.float32),
            rng.normal(0, 1, (BH, S, N)).astype(np.float32))


def _cast(arrays, dtype):
    """x, B and C in ``dtype`` (dt and a stay float32), for both packages."""
    x, dt, a, bm, cm = arrays
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm, jd),
          jnp.asarray(cm, jd)]
    tx = [torch.as_tensor(x).to(td), torch.as_tensor(dt), torch.as_tensor(a),
          torch.as_tensor(bm).to(td), torch.as_tensor(cm).to(td)]
    return jx, tx


@pytest.mark.parametrize("BH,S,P,N,Q,dtype", HEAD_CASES)
def test_plain_matches_reference_and_pallas(BH, S, P, N, Q, dtype):
    jx, tx = _cast(_head_inputs(BH, S, P, N, seed=S + P), dtype)
    y, h = ssd_scan_ref(*tx)
    assert y.dtype == getattr(torch, dtype) and h.dtype == torch.float32
    assert h.shape == (BH, P, N)
    y = np_(y)
    np.testing.assert_allclose(y, np.asarray(j_ssd_scan_ref(*jx), np.float32),
                               atol=SSD_TOL[dtype], rtol=0)
    np.testing.assert_allclose(y, np.asarray(ssd_scan_pallas(*jx, block_q=Q, interpret=True),
                                             np.float32), atol=SSD_TOL[dtype], rtol=0)


@pytest.mark.parametrize("B,S,H,P,G,N,Q", [(2, 32, 4, 8, 1, 16, 8), (2, 64, 6, 8, 2, 8, 16),
                                           (1, 48, 4, 16, 4, 8, 16)])
def test_model_layout_op_matches_reference_op(B, S, H, P, G, N, Q):
    arrays = ssd_model_inputs(B, S, H, P, G, N, seed=B * S + G)
    jx, tx = _cast(arrays, "float32")
    y, h = ssd_scan(*tx, block_q=Q)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    for use_pallas in (True, False):
        ref = j_ssd_scan(*jx, use_pallas=use_pallas, interpret=True, block_q=Q)
        np.testing.assert_allclose(np_(y), np.asarray(ref), atol=1e-3, rtol=0)


@pytest.mark.parametrize("G", [1, 2])
def test_final_state_matches_chunked_h_final(G):
    """The plain version's final state is ``_ssd_chunked``'s ``h_final``
    (``ssm.py:134``), which prefill hands to decode."""
    B, S, H, P, N = 2, 32, 4, 8, 16
    jx, tx = _cast(ssd_model_inputs(B, S, H, P, G, N, seed=3 + G), "float32")
    cfg = JModelConfig("t", "ssm", n_layers=1, d_model=16, vocab_size=8, ssm_state=N,
                       ssm_head_dim=P, ssm_groups=G, ssm_chunk=8)
    y_ref, h_ref = _ssd_chunked(*jx, cfg)
    y, h = ssd_scan(*tx)
    np.testing.assert_allclose(np_(h), np.asarray(h_ref), atol=1e-3, rtol=0)
    np.testing.assert_allclose(np_(y), np.asarray(y_ref), atol=1e-3, rtol=0)


def test_plain_takes_a_partial_last_chunk():
    """S = 37 is no multiple of any chunk: the plain version is per
    timestep, and the kernel runs the partial chunk by its length."""
    jx, tx = _cast(ssd_model_inputs(2, 37, 4, 8, 1, 8, seed=37), "float32")
    y, _ = ssd_scan(*tx, block_q=16)
    np.testing.assert_allclose(np_(y), np.asarray(j_ssd_scan(*jx)), atol=1e-3, rtol=0)


def test_chunk_fits_shared_memory():
    assert chunk_for(128, 1024, 64, 64) == 64         # zamba2: at most 64
    assert chunk_for(128, 50, 64, 64) == 50           # short sequence
    assert chunk_for(8, 1024, 16, 16) == 8            # smoke chunk
    assert chunk_for(64, 1024, 64, 512) == 16         # wide state: halved to fit
    with pytest.raises(ValueError, match="shared memory"):
        chunk_for(128, 1024, 1024, 1024)
    # the bfloat16 body: 128 whatever block_q and S, 64 where 128 does not fit
    assert chunk_for(128, 1024, 64, 64, bf16=True) == 128      # zamba2
    assert chunk_for(8, 16, 16, 16, bf16=True) == 128          # smoke: one partial chunk
    assert chunk_for(256, 1024, 64, 128, bf16=True) == 64      # mamba2-130m: N 128
    with pytest.raises(ValueError, match="shared memory"):
        chunk_for(128, 1024, 256, 256, bf16=True)


# (B, S, H, P, G, N, chunk): chunks 8 to 128, G = 1 and G > 1, S a multiple of the chunk
CHUNKED_CASES = [
    (2, 64, 4, 8, 1, 16, 8),
    (2, 96, 4, 8, 2, 8, 32),
    (1, 128, 6, 16, 3, 8, 64),
    (1, 256, 4, 8, 1, 16, 128),
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", CHUNKED_CASES)
def test_chunked_plain_matches_pallas_and_per_step(B, S, H, P, G, N, chunk):
    """The three passes give the reference's Pallas kernel's y (interpret
    mode, the same chunk) and the per-step recurrence's y and final state."""
    jx, tx = _cast(ssd_model_inputs(B, S, H, P, G, N, seed=S + chunk), "float32")
    y, h = ssd_scan_chunked_ref(*tx, chunk=chunk)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    pallas = j_ssd_scan(*jx, use_pallas=True, interpret=True, block_q=chunk)
    np.testing.assert_allclose(np_(y), np.asarray(pallas), atol=1e-3, rtol=0)
    y_step, h_step = ssd_scan_model_ref(*tx)
    np.testing.assert_allclose(np_(y), np_(y_step), atol=1e-3, rtol=0)
    np.testing.assert_allclose(np_(h), np_(h_step), atol=1e-3, rtol=0)


# partial last chunks and S < chunk
@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [(2, 37, 4, 8, 2, 16, 16), (1, 20, 4, 8, 1, 8, 32),
                                               (2, 100, 4, 8, 4, 8, 128), (1, 130, 2, 8, 1, 8, 64)])
def test_chunked_plain_takes_partial_chunks(B, S, H, P, G, N, chunk):
    jx, tx = _cast(ssd_model_inputs(B, S, H, P, G, N, seed=S * G), "float32")
    y, h = ssd_scan_chunked_ref(*tx, chunk=chunk)
    np.testing.assert_allclose(np_(y), np.asarray(j_ssd_scan(*jx)), atol=1e-3, rtol=0)
    np.testing.assert_allclose(np_(h), np_(ssd_scan_model_ref(*tx)[1]), atol=1e-3, rtol=0)


def test_state_passing_gives_the_state_at_each_chunk_start():
    """Pass 2's state entering chunk c is the recurrence's state after the
    first c chunks, and the reference's ``_ssd_chunked`` ends in the same
    final state."""
    B, S, H, P, G, N, Q = 2, 48, 4, 8, 2, 8, 16
    jx, tx = _cast(ssd_model_inputs(B, S, H, P, G, N, seed=11), "float32")
    x, dt, a, bm, cm = tx
    states, decay = ssd_chunk_states(x, dt, a, bm, Q)
    entering, h = ssd_state_passing(states, decay)
    assert not entering[:, :, 0].any()
    for c in range(1, S // Q):
        _, h_c = ssd_scan_model_ref(x[:, :c * Q], dt[:, :c * Q], a, bm[:, :c * Q], cm[:, :c * Q])
        np.testing.assert_allclose(np_(entering[:, :, c]), np_(h_c), atol=1e-4, rtol=0)
    cfg = JModelConfig("t", "ssm", n_layers=1, d_model=16, vocab_size=8, ssm_state=N,
                       ssm_head_dim=P, ssm_groups=G, ssm_chunk=Q)
    np.testing.assert_allclose(np_(h), np.asarray(_ssd_chunked(*jx, cfg)[1]), atol=1e-3, rtol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((1, 4, 2, 8))
    bm = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, torch.zeros((1, 4, 2)), torch.zeros(2), bm, bm)
