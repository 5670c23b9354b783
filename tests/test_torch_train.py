"""The port's training path (``train/train_step.py``, the differentiable
forward, the flash-attention and SSD autograd Functions, ``_ssd_chunked``)
against the JAX package on the CPU.

* ``xent_loss`` with masking and z-loss: within 1e-6 relative.
* One float32 step's loss and every leaf's gradient against
  ``jax.value_and_grad`` of the reference's forward at ``attn_impl =
  ssm_impl = "xla"`` (its training path), on the smoke configs of every
  family, the same weights (``convert``) and batch (``smoke_batch``): loss
  within 1e-5 relative, each gradient leaf within 2e-5 of its largest
  magnitude.  (Adam's first step acts like sign-SGD on near-zero gradients,
  the reference's ``tests/test_train.py:45-49``, so gradients are compared,
  and whole steps by their loss.)
* A step taken from a mid-run state (``convert.train_state_from_numpy``
  after two reference steps): the next two steps' loss and grad norm within
  1e-5 relative.
* The reference's own cases on the port: gradient accumulation, loss
  decreases under both optimizers, bfloat16 params.
* The autograd Functions on the CPU: gradients equal autograd of ``_sdpa``
  and ``_ssd_chunked`` (what their backward computes) and, within 1e-5 of
  the largest magnitude, autograd through the forward's plain version.
* ``_ssd_chunked`` from a non-zero ``h0`` against the reference's: y and
  the final state within 1e-5 relative in float32, within 2e-2 of y's
  largest magnitude in bfloat16 (the intra-chunk tensors round to bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_batch as j_smoke_batch
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JModelConfig
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import smoke_batch
from repro_torch.convert import train_state_from_numpy
from repro_torch.device import make_generator
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan.ref import ssd_scan_model_ref
from repro_torch.models import encdec, lm
from repro_torch.models.layers import _FlashAttention, _sdpa
from repro_torch.models.ssm import _ssd_chunked, _SSDScan
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from _torch_port import np_, port_config, port_lm_params

LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
# one arch of each family: dense, moe, ssm, hybrid, vlm, encdec
FAMILY_ARCHS = ["granite-3-2b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-2.7b",
                "phi-3-vision-4.2b", "whisper-base"]
# the reference's tests/test_train.py config
CFG = JModelConfig("t", "dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                   head_dim=8, d_ff=64, vocab_size=64, remat=False, dtype="float32")


def _rel(got, want) -> float:
    got, want = np_(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _tokens_batch(seed, b=8, s=16, vocab=64):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_xent_loss_masking_and_z_loss():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 7, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (3, 7)).astype(np.int32)
    for z in (0.0, 1e-4, 0.1):
        want = float(jts.xent_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=z))
        got = float(tts.xent_loss(torch.as_tensor(logits), torch.as_tensor(labels), z_loss=z))
        assert got == pytest.approx(want, rel=1e-6)
    # all positions masked: the denominator is clamped to 1, the loss is 0
    none = -np.ones_like(labels)
    assert float(tts.xent_loss(torch.as_tensor(logits), torch.as_tensor(none))) == 0.0
    uniform = tts.xent_loss(torch.zeros(2, 4, 8), torch.tensor([[1, 2, -1, -1], [3, -1, -1, -1]]),
                            z_loss=0.0)
    assert float(uniform) == pytest.approx(np.log(8), rel=1e-6)


def _loss_and_grads(params, batch, cfg):
    for p in params.parameters():
        p.requires_grad_(True)
        p.grad = None
    forward = (encdec if cfg.family == "encdec" else lm).forward
    loss = tts.xent_loss(forward(params, batch, cfg), batch["labels"])
    loss.backward()
    grads = [torch.stack([t.grad for t in g.tensors]) if g.stacked else g.tensors[0].grad
             for g in topt.leaf_groups(params)]
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_equal_the_reference(arch):
    jcfg = dataclasses.replace(j_get_arch(arch).smoke, dtype="float32", remat=False,
                               attn_impl="xla", ssm_impl="xla")
    jmod = jencdec if jcfg.family == "encdec" else jlm
    jparams = jmod.init_params(jax.random.key(0), jcfg)
    jbatch = j_smoke_batch(jcfg, batch=2, seq=32, seed=1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jts.xent_loss(jmod.forward(p, jbatch, jcfg), jbatch["labels"]))(jparams)
    cfg = port_config(jcfg)
    params = port_lm_params(jparams, cfg)
    loss, grads = _loss_and_grads(params, smoke_batch(cfg, batch=2, seq=32, seed=1), cfg)
    assert loss == pytest.approx(float(jloss), rel=LOSS_TOL)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        err = _rel(g, jg)
        assert err <= GRAD_TOL, f"{arch} gradient leaf {i} {tuple(g.shape)}: {err}"


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_steps_from_a_mid_run_state_equal_the_reference(opt_name):
    """Two reference steps, the state carried across, then two steps in each
    package: equal losses and grad norms."""
    jo = jopt.make_optimizer(opt_name, jopt.warmup_cosine(3e-3, warmup=5, total=100))
    to = topt.make_optimizer(opt_name, topt.warmup_cosine(3e-3, warmup=5, total=100))
    jstep = jax.jit(jts.make_train_step(CFG, jo, accum_steps=2))
    state = jts.init_train_state(jax.random.key(0), CFG, jo)
    for s in range(2):
        state, _ = jstep(state, _j(_tokens_batch(s)))
    host = jax.tree.map(np.asarray, state)
    tstate = train_state_from_numpy(host.step, host.params, host.opt_state, port_config(CFG),
                                    opt_name, device="cpu")
    assert int(tstate.step) == 2
    tstep = tts.make_train_step(port_config(CFG), to, accum_steps=2)
    for s in range(2, 4):
        batch = _tokens_batch(s)
        state, jm = jstep(state, _j(batch))
        tstate, tm = tstep(tstate, _t(batch))
        assert int(tm["step"]) == int(jm["step"]) == s
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_TOL)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=LOSS_TOL)
    assert int(tstate.step) == 4
    with pytest.raises(ValueError, match="not 'adamw'"):
        train_state_from_numpy(host.step, host.params, {"v": []}, port_config(CFG), "adamw",
                               device="cpu")


def test_grad_accum_equivalence():
    """Microbatch-accumulated gradients equal the full-batch gradient, and the
    step's loss agrees between accum settings (the reference's test)."""
    cfg = port_config(CFG)
    params = lm.init_params(make_generator(0), cfg, for_training=True)
    batch = _t(_tokens_batch(2, b=8))
    _, g_full = _loss_and_grads(params, batch, cfg)
    g_acc = [torch.zeros_like(g) for g in g_full]
    for i in range(4):
        mb = {k: v[2 * i:2 * i + 2] for k, v in batch.items()}
        _, g = _loss_and_grads(params, mb, cfg)
        g_acc = [a + b / 4.0 for a, b in zip(g_acc, g)]
    for a, b in zip(g_full, g_acc):
        np.testing.assert_allclose(np_(a), np_(b), atol=1e-4, rtol=1e-3)
    opt = topt.adamw(lambda s: 1e-2)
    m = {}
    for accum in (1, 4):
        s0 = tts.init_train_state(make_generator(0), cfg, opt)
        _, m[accum] = tts.make_train_step(cfg, opt, accum_steps=accum)(s0, batch)
    assert float(m[1]["loss"]) == pytest.approx(float(m[4]["loss"]), rel=1e-3)
    with pytest.raises(ValueError, match="microbatches"):
        tts.make_train_step(cfg, opt, accum_steps=3)(s0, batch)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_loss_decreases(opt_name):
    cfg = port_config(CFG)
    opt = topt.make_optimizer(opt_name, topt.warmup_cosine(3e-3, warmup=5, total=100))
    state = tts.init_train_state(make_generator(0), cfg, opt)
    step = tts.make_train_step(cfg, opt, accum_steps=1)
    batch = _t(_tokens_batch(1))
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1, f"no learning: {losses[0]} -> {losses[-1]}"
    assert int(state.step) == 15


def test_bf16_param_training():
    cfg = dataclasses.replace(port_config(CFG), param_dtype=torch.bfloat16)
    opt = topt.adafactor(lambda s: 1e-2)
    state = tts.init_train_state(make_generator(0), cfg, opt)
    assert {p.dtype for p in state.params.parameters()} == {torch.bfloat16}
    state, m = tts.make_train_step(cfg, opt, accum_steps=2)(state, _t(_tokens_batch(3)))
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    assert state.params["embed"].dtype == torch.bfloat16


def test_training_init_keeps_param_dtype_and_serving_init_does_not():
    cfg = port_config(CFG)
    served = lm.init_params(make_generator(0), dataclasses.replace(cfg, dtype=torch.bfloat16))
    trained = lm.init_params(make_generator(0), dataclasses.replace(cfg, dtype=torch.bfloat16),
                             for_training=True)
    assert served["layers"][0]["attn"]["q"].dtype == torch.bfloat16
    assert {p.dtype for p in trained.parameters()} == {torch.float32}
    np.testing.assert_array_equal(np_(served["layers"][0]["attn"]["q"]),
                                  np_(trained["layers"][0]["attn"]["q"].to(torch.bfloat16)))
    # serving through make_serve_step equals lm.prefill / lm.decode
    toks = torch.as_tensor(_tokens_batch(4, b=2, s=8)["tokens"])
    logits, cache = tts.make_serve_step(cfg, "prefill", max_len=10)(trained, {"tokens": toks})
    want, _ = lm.prefill(trained, {"tokens": toks}, cfg, max_len=10)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    nxt, _ = tts.make_serve_step(cfg, "decode")(trained, cache, toks[:, :1], 8)
    assert nxt.shape == (2, 1, cfg.vocab_size)


# ---------------------------------------------------------------------------
# the autograd Functions and _ssd_chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,Sq,Skv", [(True, 24, 24), (False, 8, 20)])
def test_flash_attention_function_gradient(causal, Sq, Skv):
    gen = make_generator(5)
    q = torch.randn(2, Sq, 4, 8, generator=gen, requires_grad=True)
    k = torch.randn(2, Skv, 2, 8, generator=gen, requires_grad=True)
    v = torch.randn(2, Skv, 2, 8, generator=gen, requires_grad=True)
    do = torch.randn(2, Sq, 4, 8, generator=gen)
    got = torch.autograd.grad(_FlashAttention.apply(q, k, v, causal), (q, k, v), do)
    via_sdpa = torch.autograd.grad(_sdpa(q, k, v, causal=causal), (q, k, v), do)
    via_plain = torch.autograd.grad(attention_ref(q, k, v, causal=causal), (q, k, v), do)
    for g, s, p in zip(got, via_sdpa, via_plain):
        torch.testing.assert_close(g, s, rtol=0, atol=0)
        assert _rel(g, np_(p)) <= 1e-5
    # only the inputs that need a gradient get one
    dq, = torch.autograd.grad(_FlashAttention.apply(q, k.detach(), v.detach(), causal), (q,), do)
    torch.testing.assert_close(dq, got[0], rtol=0, atol=0)


def _ssd_inputs(B=2, S=32, H=4, P=8, G=2, N=8, seed=6, requires_grad=True):
    """x, B and C as views into one tensor, as ssm_block slices them."""
    gen = make_generator(seed)
    xbc = torch.randn(B, S, H * P + 2 * G * N, generator=gen).requires_grad_(requires_grad)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    cm = xbc[..., H * P + G * N:].reshape(B, S, G, N)
    dt = (0.01 + 0.2 * torch.rand(B, S, H, generator=gen)).requires_grad_(requires_grad)
    a = (-(0.5 + 3.5 * torch.rand(H, generator=gen))).requires_grad_(requires_grad)
    return xbc, (x, dt, a, bm, cm)


def test_ssd_function_gradient():
    cfg = port_config(CFG)
    cfg = dataclasses.replace(cfg, ssm_chunk=8)
    xbc, (x, dt, a, bm, cm) = _ssd_inputs()
    y, h = _SSDScan.apply(x, dt, a, bm, cm, cfg)
    assert not h.requires_grad
    dy = torch.randn(y.shape, generator=make_generator(7))
    got = torch.autograd.grad(y, (xbc, dt, a), dy)
    via_chunked = torch.autograd.grad(_ssd_chunked(x, dt, a, bm, cm, cfg)[0], (xbc, dt, a), dy)
    via_plain = torch.autograd.grad(ssd_scan_model_ref(x, dt, a, bm, cm)[0], (xbc, dt, a), dy)
    for g, c, p in zip(got, via_chunked, via_plain):
        torch.testing.assert_close(g, c, rtol=0, atol=0)
        assert _rel(g, np_(p)) <= 1e-5
    with pytest.raises(ValueError, match="multiple of the chunk"):
        _ssd_chunked(x[:, :30], dt[:, :30], a, bm[:, :30], cm[:, :30], cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_from_a_state_equals_the_reference(dtype):
    _, (x, dt, a, bm, cm) = _ssd_inputs(requires_grad=False)
    h0 = torch.randn(2, 4, 8, 8, generator=make_generator(8))
    jcfg = dataclasses.replace(CFG, ssm_chunk=8, dtype=dtype)
    cfg = port_config(jcfg)
    tdt = getattr(torch, dtype)
    x, bm, cm = (t.to(tdt) for t in (x, bm, cm))
    y, h = _ssd_chunked(x, dt, a, bm, cm, cfg, h0=h0)
    J = lambda t: jnp.asarray(np_(t), dtype)                    # noqa: E731
    jy, jh = jssm._ssd_chunked(J(x), jnp.asarray(np_(dt)), jnp.asarray(np_(a)), J(bm), J(cm),
                               jcfg, h0=jnp.asarray(np_(h0)))
    assert y.dtype == tdt and h.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel(y, np.asarray(jy, np.float32)) <= tol
    assert _rel(h, np.asarray(jh)) <= (1e-5 if dtype == "float32" else 1e-2)
    # the start state matters: from zeros the result differs
    y0, _ = _ssd_chunked(x, dt, a, bm, cm, cfg)
    assert _rel(y0, np.asarray(jy, np.float32)) > 10 * tol


def test_ssd_chunked_gradient_stays_finite_past_exp_overflow():
    """Where a chunk's decays span more than 88.7 (exp overflows float32),
    the reference's ``_ssd_chunked`` gives NaN gradients (ROADMAP C4: it
    zeroes exp(la_q - la_k) of the upper triangle after computing it); the
    port masks the exponent first: the same y within 1e-5, and a gradient
    equal, within 1e-3 of its largest magnitude, to autograd through the
    per-timestep plain version (A's gradient sums every position's decays,
    down to exp(-90), in another order: 1.8e-4 here)."""
    cfg = dataclasses.replace(port_config(CFG), ssm_chunk=16)
    jcfg = dataclasses.replace(CFG, ssm_chunk=16)
    _, (x, dt, a, bm, cm) = _ssd_inputs(S=16, requires_grad=False)
    dt = torch.full_like(dt, 1.5)                    # 15 steps x 1.5 x |a| up to 4: span ~90
    a = a.detach().clone().fill_(-4.0).requires_grad_(True)
    x, bm, cm = (t.detach().clone().requires_grad_(True) for t in (x, bm, cm))
    dt.requires_grad_(True)
    y, _ = _ssd_chunked(x, dt, a, bm, cm, cfg)
    y_plain, _ = ssd_scan_model_ref(x, dt, a, bm, cm)
    assert _rel(y, np_(y_plain)) <= 1e-5
    dy = torch.randn(y.shape, generator=make_generator(9))
    got = torch.autograd.grad(y, (x, dt, a, bm, cm), dy)
    want = torch.autograd.grad(y_plain, (x, dt, a, bm, cm), dy)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, np_(w)) <= 1e-3
    J = lambda t: jnp.asarray(np_(t))                           # noqa: E731
    jgrad = jax.grad(lambda *args: jnp.sum(jssm._ssd_chunked(*args, jcfg)[0] * J(dy)),
                     argnums=(1, 2))(J(x), J(dt), J(a), J(bm), J(cm))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrad)
