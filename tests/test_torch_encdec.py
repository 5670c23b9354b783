"""The port's encoder-decoder (``models/encdec.py``) and its building blocks
(``layer_norm``, ``sinusoidal_pos``) against the reference, on the same
weights (``convert.lm_params_from_numpy``) and numpy inputs, in float32 on
the CPU.

* ``layer_norm`` within 1e-5, ``sinusoidal_pos`` within 1e-5 (float32 sin
  and cos of angles up to ~S).
* ``forward`` within 2e-4 of the reference's (tests/test_torch_lm.py's
  forward tolerance), for the whisper-base smoke config.
* ``prefill`` + ``decode`` step by step: every step's logits and both
  caches (self K/V padded to ``max_dec_len``, cross K/V) within 1e-4, for
  ``tests/test_serve.py``'s encdec case and the whisper-base smoke config.
* the serving invariant on the port alone: decode step t reproduces the
  forward logits at position t within 1e-2 (``tests/test_serve.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.models import encdec, layers
from _torch_port import np_, port_config, port_lm_params

V = 64
# tests/test_serve.py's encdec case, and the whisper-base smoke config, float32
CASES = [
    JModelConfig("encdec", "encdec", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                 head_dim=8, d_ff=64, vocab_size=V, n_enc_layers=2, act="gelu", glu=False,
                 max_dec_len=16, remat=False, dtype="float32"),
    dataclasses.replace(j_get_arch("whisper-base").smoke, dtype="float32", remat=False),
]
IDS = [c.name for c in CASES]


def _port(jcfg, seed=0):
    jparams = jencdec.init_params(jax.random.key(seed), jcfg)
    cfg = port_config(jcfg)
    return jparams, cfg, port_lm_params(jparams, cfg)


def _inputs(cfg, B=2, S_enc=24, S_dec=16, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.normal(0, 1, (B, S_enc, cfg.d_model)).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab_size, (B, S_dec)).astype(np.int32)


def test_layer_norm_and_sinusoidal_pos():
    rng = np.random.default_rng(0)
    x = rng.normal(1, 3, (3, 5, 48)).astype(np.float32)
    scale, bias = rng.normal(1, 0.2, 48).astype(np.float32), rng.normal(0, 1, 48).astype(np.float32)
    ref = np.asarray(jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    out = layers.layer_norm(torch.as_tensor(x), torch.as_tensor(scale), torch.as_tensor(bias))
    np.testing.assert_allclose(np_(out), ref, atol=1e-5, rtol=0)
    for S, D in ((24, 32), (1500, 512)):
        ref = np.asarray(jlayers.sinusoidal_pos(S, D))
        out = layers.sinusoidal_pos(S, D)
        assert out.shape == (S, D) and out.dtype == torch.float32
        np.testing.assert_allclose(np_(out), ref, atol=1e-5, rtol=0)
    assert layers.sinusoidal_pos(8, 16, torch.bfloat16).dtype == torch.bfloat16


def test_forward_matches_reference():
    jcfg = CASES[1]
    jparams, cfg, params = _port(jcfg)
    frames, toks = _inputs(cfg, S_enc=32, S_dec=16)
    ref = np.asarray(jencdec.forward(
        jparams, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}, jcfg))
    out = encdec.forward(params, {"frames": torch.as_tensor(frames),
                                  "tokens": torch.as_tensor(toks)}, cfg)
    assert out.shape == (2, 16, cfg.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(np_(out), ref, atol=2e-4, rtol=0)


def _serve_reference(jparams, jcfg, frames, toks, prompt):
    prefill = jax.jit(lambda p, f, t: jencdec.prefill(p, {"frames": f, "tokens": t}, jcfg,
                                                      max_dec_len=toks.shape[1]))
    decode = jax.jit(lambda p, c, tok, pos: jencdec.decode(p, c, tok, pos, jcfg))
    logits, cache = prefill(jparams, jnp.asarray(frames), jnp.asarray(toks[:, :prompt]))
    outs = [logits[:, 0]]
    for t in range(prompt, toks.shape[1]):
        lg, cache = decode(jparams, cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        outs.append(lg[:, 0])
    return np.asarray(jnp.stack(outs, axis=1)), cache


def _serve_port(params, cfg, frames, toks, prompt):
    frames, toks = torch.as_tensor(frames), torch.as_tensor(toks)
    logits, cache = encdec.prefill(params, {"frames": frames, "tokens": toks[:, :prompt]}, cfg,
                                   max_dec_len=toks.shape[1])
    outs = [logits[:, 0]]
    for t in range(prompt, toks.shape[1]):
        lg, cache = encdec.decode(params, cache, toks[:, t:t + 1], t, cfg)
        outs.append(lg[:, 0])
    return np_(torch.stack(outs, dim=1)), cache


@pytest.mark.parametrize("jcfg", CASES, ids=IDS)
def test_prefill_decode_match_reference(jcfg):
    jparams, cfg, params = _port(jcfg)
    frames, toks = _inputs(cfg)
    ref, ref_cache = _serve_reference(jparams, jcfg, frames, toks, prompt=8)
    out, cache = _serve_port(params, cfg, frames, toks, prompt=8)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert isinstance(cache, encdec.EncDecCache)
    ref_leaves, port_leaves = jax.tree.leaves(ref_cache), list(cache.self_kv) + list(cache.cross_kv)
    assert len(ref_leaves) == len(port_leaves) == 4
    for r, p in zip(ref_leaves, port_leaves):
        assert p.shape == r.shape
        np.testing.assert_allclose(np_(p), np.asarray(r, np.float32), atol=1e-4, rtol=0)


@pytest.mark.parametrize("jcfg", CASES, ids=IDS)
def test_decode_matches_forward(jcfg):
    _, cfg, params = _port(jcfg)
    frames, toks = _inputs(cfg)
    full = np_(encdec.forward(params, {"frames": torch.as_tensor(frames),
                                       "tokens": torch.as_tensor(toks)}, cfg))
    dec, _ = _serve_port(params, cfg, frames, toks, prompt=8)
    np.testing.assert_allclose(dec, full[:, 7:, :], atol=1e-2, rtol=1e-2)


def test_cross_kv_is_computed_once():
    """Decode reads the cross K/V prefill stored and leaves them as they are;
    the self-attention cache is written in place at ``pos``."""
    jcfg = CASES[0]
    _, cfg, params = _port(jcfg)
    frames, toks = _inputs(cfg)
    _, cache = encdec.prefill(params, {"frames": torch.as_tensor(frames),
                                       "tokens": torch.as_tensor(toks[:, :8])}, cfg)
    assert cache.self_kv.k.shape == (cfg.n_layers, 2, cfg.max_dec_len, cfg.n_kv_heads,
                                     cfg.head_dim)
    assert not cache.self_kv.k[:, :, 8:].any()
    cross = cache.cross_kv.k.clone()
    _, same = encdec.decode(params, cache, torch.as_tensor(toks[:, 8:9]), 8, cfg)
    assert same is cache and torch.equal(cache.cross_kv.k, cross)
    assert cache.self_kv.k[:, :, 8].abs().sum() > 0 and not cache.self_kv.k[:, :, 9:].any()
