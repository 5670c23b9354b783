"""Remat in the port (``ModelConfig.remat``, ``lm.layer_runner``) on the CPU.

* Per family (dense, moe, ssm, hybrid, vlm, encdec; smoke configs in
  float32): the loss and every gradient with ``remat=True`` equal those with
  ``remat=False`` bit for bit.  The checkpointed body runs the same float32
  operations on the same inputs again, and every parameter's gradient is
  summed in the same order.
* The same ``remat=True`` loss and gradients against ``jax.value_and_grad``
  of the reference's forward with ``remat=True`` (its ``jax.checkpoint`` of
  each scanned body) on the same weights and batch: loss within 1e-5
  relative, each gradient leaf within 2e-5 of its largest magnitude, the
  tolerances of ``tests/test_torch_train.py``.
* Under remat the flash-attention and SSD ops run twice per forward and
  backward (the forward, then the recomputed forward); prefill, decode and a
  forward under ``no_grad`` run them once, as without remat.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_batch as j_smoke_batch
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.train import train_step as jts
from repro_torch.configs import get_arch, smoke_batch
from repro_torch.device import make_generator
from repro_torch.models import encdec, layers, lm, ssm
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from _torch_port import port_config, port_lm_params
from test_torch_train import FAMILY_ARCHS, GRAD_TOL, LOSS_TOL, _rel


def _loss_and_grads(params, batch, cfg):
    for p in params.parameters():
        p.requires_grad_(True)
        p.grad = None
    forward = (encdec if cfg.family == "encdec" else lm).forward
    loss = tts.xent_loss(forward(params, batch, cfg), batch["labels"])
    loss.backward()
    grads = [torch.stack([t.grad for t in g.tensors]) if g.stacked else g.tensors[0].grad
             for g in topt.leaf_groups(params)]
    return loss.detach(), grads


def _port(arch, remat):
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32, remat=remat)
    mod = encdec if cfg.family == "encdec" else lm
    return cfg, mod.init_params(make_generator(0), cfg, for_training=True)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_equals_no_remat(arch):
    cfg, params = _port(arch, remat=True)
    batch = smoke_batch(cfg, batch=2, seq=32, seed=1)
    loss, grads = _loss_and_grads(params, batch, cfg)
    loss0, grads0 = _loss_and_grads(params, batch, dataclasses.replace(cfg, remat=False))
    assert torch.equal(loss, loss0)
    assert len(grads) == len(grads0)
    for i, (g, g0) in enumerate(zip(grads, grads0)):
        torch.testing.assert_close(g, g0, rtol=0, atol=0, msg=f"{arch} gradient leaf {i}")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_gradients_equal_the_reference(arch):
    jcfg = dataclasses.replace(j_get_arch(arch).smoke, dtype="float32", remat=True,
                               attn_impl="xla", ssm_impl="xla")
    jmod = jencdec if jcfg.family == "encdec" else jlm
    jparams = jmod.init_params(jax.random.key(0), jcfg)
    jbatch = j_smoke_batch(jcfg, batch=2, seq=32, seed=1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jts.xent_loss(jmod.forward(p, jbatch, jcfg), jbatch["labels"]))(jparams)
    cfg = port_config(jcfg)
    assert cfg.remat
    params = port_lm_params(jparams, cfg)
    loss, grads = _loss_and_grads(params, smoke_batch(cfg, batch=2, seq=32, seed=1), cfg)
    assert float(loss) == pytest.approx(float(jloss), rel=LOSS_TOL)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        err = _rel(g, jg)
        assert err <= GRAD_TOL, f"{arch} gradient leaf {i} {tuple(g.shape)}: {err}"


class _Counted:
    """Counts the calls of the flash-attention and SSD ops the models hold."""

    def __init__(self, monkeypatch):
        self.calls = {"flash_attention": 0, "ssd_scan": 0}
        for mod, name in ((layers, "flash_attention"), (ssm, "ssd_scan")):
            fn = getattr(mod, name)

            def counted(*args, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*args, **kw)
            monkeypatch.setattr(mod, name, counted)

    def take(self):
        out = dict(self.calls)
        self.calls.update({k: 0 for k in self.calls})
        return out


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-base"])
def test_remat_runs_the_kernels_twice_and_serving_once(arch, monkeypatch):
    counted = _Counted(monkeypatch)
    cfg, params = _port(arch, remat=True)
    batch = smoke_batch(cfg, batch=2, seq=32, seed=1)
    if cfg.family == "encdec":
        once = {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers, "ssd_scan": 0}
    else:
        once = {"flash_attention": cfg.n_layers // cfg.shared_attn_every,
                "ssd_scan": cfg.n_layers}
    for remat, factor in ((True, 2), (False, 1)):
        _loss_and_grads(params, batch, dataclasses.replace(cfg, remat=remat))
        assert counted.take() == {k: factor * v for k, v in once.items()}, remat
    mod = encdec if cfg.family == "encdec" else lm
    with torch.no_grad():
        mod.forward(params, batch, cfg)
    assert counted.take() == once
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    _, cache = mod.prefill(params, prompt, cfg)
    assert counted.take() == once
    pos = prompt["tokens"].shape[1]
    mod.decode(params, cache, prompt["tokens"][:, :1], pos, cfg)
    assert counted.take() == {"flash_attention": 0, "ssd_scan": 0}
