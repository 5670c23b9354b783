"""The port's sharding-aware matmul (``models/pmm.py``) and the projections
that route through it (``layers._proj``, ``moe._emm``), on the CPU.

* The reference's six subscripts (``tests/test_pmm.py:11-18``): value and
  gradients equal ``torch.einsum`` autograd's and the reference's
  ``matmul`` on the same inputs, rtol 1e-4 and atol 1e-5 (the reference's
  own tolerance); the value within 1e-5 relative.
* Under ``torch.utils.checkpoint`` inside a loop of layers
  (``tests/test_pmm.py:39``): the same tolerance against plain einsum and
  against the reference's ``jax.checkpoint`` + ``scan``.
* On 8 gloo ranks with a (2, 4) (data, model) mesh, DTensor operands and
  each subscript's weight spec from the model code: values and gradients
  equal the unsharded product's within 1e-5, and dW's placements equal
  ``meta[0]``'s spec.
* ``grad_shard=True`` on one process (no mesh: every layout pin is a no-op)
  trains the dense and moe smoke configs to the same loss and gradients as
  ``grad_shard=False``, within 1e-6 relative (einsum and matmul may order
  their sums differently).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.config import ModelConfig as JModelConfig
from repro.models.layers import _sanitize_dw_spec as j_sanitize_dw_spec
from repro.models.pmm import matmul as jmatmul
from repro_torch.configs import get_arch, smoke_batch
from repro_torch.device import make_generator
from repro_torch.models import lm
from repro_torch.models.layers import _sanitize_dw_spec
from repro_torch.models.pmm import matmul
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from _torch_port import port_config, run_ranks

SUBS = [
    ("bsd,df->bsf", (2, 8, 16), (16, 32)),
    ("bsf,fd->bsd", (2, 8, 32), (32, 16)),
    ("bsd,dhk->bshk", (2, 8, 16), (16, 4, 8)),
    ("bshk,hkd->bsd", (2, 8, 4, 8), (4, 8, 16)),
    ("ecd,edf->ecf", (4, 8, 16), (4, 16, 8)),
    ("ecf,efd->ecd", (4, 8, 16), (4, 16, 8)),
]
# each subscript's weight spec where the model code uses it
DW_SPECS = {"bsd,df->bsf": ("data", "model"), "bsf,fd->bsd": ("model", "data"),
            "bsd,dhk->bshk": ("data", "model", None), "bshk,hkd->bsd": ("model", None, "data"),
            "ecd,edf->ecf": ("model", "data", None), "ecf,efd->ecd": ("model", None, "data")}
RTOL, ATOL = 1e-4, 1e-5


def _inputs(xs, ws, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, xs).astype(np.float32), rng.normal(0, 1, ws).astype(np.float32)


@pytest.mark.parametrize("subs,xs,ws", SUBS, ids=[s for s, *_ in SUBS])
def test_matmul_grads_match_einsum_and_the_reference(subs, xs, ws):
    xn, wn = _inputs(xs, ws)
    x = torch.tensor(xn, requires_grad=True)
    w = torch.tensor(wn, requires_grad=True)
    loss = (matmul(x, w, subs) ** 2).sum()
    gx, gw = torch.autograd.grad(loss, (x, w))
    x2 = torch.tensor(xn, requires_grad=True)
    w2 = torch.tensor(wn, requires_grad=True)
    loss2 = (torch.einsum(subs, x2, w2) ** 2).sum()
    ex, ew = torch.autograd.grad(loss2, (x2, w2))
    jf = lambda x, w: (jmatmul(x, w, subs, None) ** 2).sum()  # noqa: E731
    jl = float(jf(jnp.asarray(xn), jnp.asarray(wn)))
    jx, jw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(xn), jnp.asarray(wn))
    assert float(loss.detach()) == pytest.approx(float(loss2.detach()), rel=1e-5)
    assert float(loss.detach()) == pytest.approx(jl, rel=1e-5)
    for got, want in ((gx, ex), (gw, ew), (gx, np.asarray(jx)), (gw, np.asarray(jw))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_matmul_keeps_dtypes():
    """The weight is cast to the activation's dtype; dW comes back in the
    weight's dtype."""
    x = torch.randn(2, 4, 8, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(8, 6, dtype=torch.float32, requires_grad=True)
    y = matmul(x, w, "bsd,df->bsf")
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    want = torch.einsum("bsd,df->bsf", x.detach(), w.detach().to(torch.bfloat16))
    torch.testing.assert_close(y.detach(), want, rtol=0, atol=0)


def test_matmul_under_remat_in_a_layer_loop():
    rng = np.random.default_rng(0)
    wn = rng.normal(0, 1, (3, 16, 16)).astype(np.float32)
    xn = rng.normal(0, 1, (2, 4, 16)).astype(np.float32)

    def layer(x, w):
        return torch.relu(matmul(x, w, "bsd,df->bsf"))

    def loss(ws, remat):
        x = torch.tensor(xn)
        for i in range(ws.shape[0]):
            x = checkpoint(layer, x, ws[i], use_reentrant=False) if remat else layer(x, ws[i])
        return (x ** 2).sum()

    ws = torch.tensor(wn, requires_grad=True)
    (g,) = torch.autograd.grad(loss(ws, True), ws)
    assert torch.isfinite(g).all()
    ws_plain = torch.tensor(wn, requires_grad=True)
    x = torch.tensor(xn)
    for i in range(3):
        x = torch.relu(torch.einsum("bsd,df->bsf", x, ws_plain[i]))
    (g_ref,) = torch.autograd.grad((x ** 2).sum(), ws_plain)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=RTOL, atol=ATOL)
    ws2 = torch.tensor(wn, requires_grad=True)
    (g_no_remat,) = torch.autograd.grad(loss(ws2, False), ws2)
    np.testing.assert_allclose(g.numpy(), g_no_remat.numpy(), rtol=0, atol=0)

    @jax.checkpoint
    def jlayer(x, w):
        return jax.nn.relu(jmatmul(x, w, "bsd,df->bsf", None))

    def jloss(ws):
        y, _ = jax.lax.scan(lambda x, w: (jlayer(x, w), None), jnp.asarray(xn), ws)
        return (y ** 2).sum()
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(wn))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("data,model", [(0, 0), (2, 4), (16, 16)])
def test_sanitize_dw_spec_equals_the_reference(data, model):
    jcfg = JModelConfig("t", "dense", 1, 16, grad_shard=True, mesh_data_size=data,
                        mesh_model_size=model)
    cfg = port_config(jcfg)
    for subs, _, ws in SUBS:
        w = torch.empty(ws, device="meta")
        assert _sanitize_dw_spec(cfg, w, DW_SPECS[subs]) == j_sanitize_dw_spec(
            jcfg, jax.ShapeDtypeStruct(ws, jnp.float32), DW_SPECS[subs])


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b"])
def test_grad_shard_trains_as_without_it(arch):
    """``_proj`` (and ``moe._emm`` with ``moe_ep_shard``) through ``pmm``
    without a mesh: the same loss and gradients as the plain products."""
    base = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    sharded = dataclasses.replace(base, grad_shard=True, moe_ep_shard=True)
    params = lm.init_params(make_generator(0), base, for_training=True)
    batch = smoke_batch(base, batch=2, seq=32, seed=1)
    out = []
    for cfg in (base, sharded):
        for p in params.parameters():
            p.requires_grad_(True)
            p.grad = None
        loss = tts.xent_loss(lm.forward(params, batch, cfg), batch["labels"])
        loss.backward()
        out.append((float(loss), [t.grad.clone() for g in topt.leaf_groups(params)
                                  for t in g.tensors]))
    (l0, g0), (l1, g1) = out
    assert l1 == pytest.approx(l0, rel=1e-6)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


_MESH_PMM = """
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.distributed.sharding import spec_placements
from repro_torch.models.pmm import matmul
SUBS = {subs!r}
DW_SPECS = {dw_specs!r}
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
out = {{}}
for subs, xs, ws in SUBS:
    gen = torch.Generator().manual_seed(len(out))
    x = torch.randn(xs, generator=gen)
    w = torch.randn(ws, generator=gen)
    spec = DW_SPECS[subs]
    meta = (spec, 2, 4, None)
    # the activation over data (its leading dim), the weight in its layout
    xd = distribute_tensor(x, mesh, spec_placements(("data",) + (None,) * (x.dim() - 1),
                                                    mesh)).requires_grad_()
    wd = distribute_tensor(w, mesh, spec_placements(spec, mesh)).requires_grad_()
    y = matmul(xd, wd, subs, meta)
    (y ** 2).sum().backward()
    xr = x.clone().requires_grad_()
    wr = w.clone().requires_grad_()
    yr = torch.einsum(subs, xr, wr)
    (yr ** 2).sum().backward()
    err = lambda a, b: float((a.full_tensor() - b).abs().max() / b.abs().max())
    out[subs] = {{"y": err(y, yr), "dx": err(xd.grad, xr.grad), "dw": err(wd.grad, wr.grad),
                 "dw_placements": [str(p) for p in wd.grad.placements],
                 "want": [str(p) for p in spec_placements(spec, mesh)]}}
print(json.dumps(out))
"""


def test_matmul_on_a_2x4_gloo_mesh(tmp_path):
    body = _MESH_PMM.format(subs=SUBS, dw_specs=DW_SPECS)
    outs = [json.loads(o.strip().splitlines()[-1]) for o in run_ranks(body, 8, tmp_path)]
    for rank, res in enumerate(outs):
        assert set(res) == set(DW_SPECS)
        for subs, r in res.items():
            assert max(r["y"], r["dx"], r["dw"]) <= 1e-5, (rank, subs, r)
            assert r["dw_placements"] == r["want"], (rank, subs, r)
