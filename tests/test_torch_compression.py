"""The port's gradient compression (``distributed/compression.py``) against
the JAX package's on the CPU.

* ``quantize_int8`` on seeded inputs: ``q`` bit-equal to the reference's,
  the scale within one float32 rounding (both divide the same float32 max
  by 127 and add 1e-12); ``dequantize_int8`` and ``ef_compress`` over
  several steps likewise.
* The reference's three cases (``tests/test_compression.py:20, :28, :42``)
  on the port.
* ``compressed_psum`` on 8 gloo ranks (separate processes): within 5e-2 of
  the largest magnitude of a plain ``all_reduce``, the reference's bound
  (``tests/test_distributed_subprocess.py:54-87``), and every rank gets the
  same sum.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as jc
from repro_torch.distributed.compression import (
    ErrorFeedback, compressed_psum, dequantize_int8, ef_compress, quantize_int8,
)
from _torch_port import run_ranks

CASES = [(0, 1.0, (256,)), (1, 0.01, (256,)), (2, 100.0, (8, 128)), (3, 3.5, (4, 33)),
         (4, 1e-3, (1000,))]


def _ulp_close(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(a - b) <= np.spacing(max(abs(a), abs(b)))


@pytest.mark.parametrize("seed,scale,shape", CASES)
def test_quantize_equals_the_reference(seed, scale, shape):
    x = np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)
    jq, js = jc.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.as_tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert _ulp_close(float(s), float(js))
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(),
                               np.asarray(jc.dequantize_int8(jq, js)), rtol=2e-7, atol=0)


def test_error_feedback_steps_equal_the_reference():
    rng = np.random.default_rng(7)
    jef, ef = jc.ErrorFeedback(jnp.zeros((64,))), ErrorFeedback(torch.zeros(64))
    for _ in range(10):
        g = (rng.normal(0, 1, (64,)) * 1e-3).astype(np.float32)
        jq, js, jef = jc.ef_compress(jnp.asarray(g), jef)
        q, s, ef = ef_compress(torch.as_tensor(g), ef)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert _ulp_close(float(s), float(js))
        np.testing.assert_allclose(ef.residual.numpy(), np.asarray(jef.residual),
                                   rtol=0, atol=float(js) * 1e-6)


@pytest.mark.parametrize("seed,scale", [(0, 0.01), (17, 1.0), (500, 37.5), (999, 100.0)])
def test_quantize_roundtrip_error_bound(seed, scale):
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, scale, (256,)), dtype=torch.float32)
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6, "error bounded by half a step"


def test_error_feedback_preserves_signal():
    """Accumulated EF-compressed updates track the true gradient sum."""
    g_true = torch.as_tensor(np.random.default_rng(0).normal(0, 1, (128,)),
                             dtype=torch.float32) * 1e-3
    ef = ErrorFeedback(torch.zeros(128))
    total = torch.zeros(128)
    for _ in range(50):
        q, s, ef = ef_compress(g_true, ef)
        total = total + dequantize_int8(q, s)
    np.testing.assert_allclose(total.numpy(), (g_true * 50).numpy(),
                               atol=float(g_true.abs().max()) * 2)


def test_zero_gradient_stays_zero():
    q, s = quantize_int8(torch.zeros(16))
    assert (q == 0).all()
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(), 0.0)


_PSUM = """
from repro_torch.distributed.compression import compressed_psum
x = torch.randn(world, 128, generator=torch.Generator().manual_seed(0))[rank].contiguous()
plain = x.clone()
dist.all_reduce(plain)
comp = compressed_psum(x)
err = float((plain - comp).abs().max() / plain.abs().max())
print(json.dumps({"err": err, "sum": comp.tolist(), "plain": plain.tolist()}))
"""


def test_compressed_psum_on_8_gloo_ranks(tmp_path):
    outs = [json.loads(o.strip().splitlines()[-1]) for o in run_ranks(_PSUM, 8, tmp_path)]
    assert all(o["err"] < 0.05 for o in outs), [o["err"] for o in outs]
    assert all(o["sum"] == outs[0]["sum"] for o in outs)
    want = torch.randn(8, 128, generator=torch.Generator().manual_seed(0)).sum(0)
    np.testing.assert_allclose(outs[0]["plain"], want.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="do not split"):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=3)
        try:
            compressed_psum(torch.zeros(8))
        finally:
            dist.destroy_process_group()
