"""The port's MoE block (``models/moe.py``) against the reference's, on the
same weights and inputs (numpy draws), in float32 on the CPU.

* ``route_topk``: expert indices equal, weights within 1e-6; ``_capacity``
  equal on a grid that includes half-way roundings.
* dispatch: the slot table (token of each expert slot) bit-equal to the one
  the reference's ``_moe_block_inner`` builds (read where it gathers with
  ``jnp.take``), with ample capacity and at ``capacity_factor`` 1.25, where
  tokens are dropped; the slot weights equal the top-k weights of the slots'
  tokens.
* ``moe_block`` and ``moe_block_dense`` within 1e-5 of the reference's
  (float32; the port adds each token's k outputs in top-k order, the
  reference scatter-adds them, so sums may differ in the last bits).
* the chunked path, ``MOE_CHUNK_TOKENS`` patched small in both packages:
  equal to the reference's chunked output within 1e-5, and with ample
  capacity to the unchunked output within 1e-6 (the expert products run
  over buffers of other sizes).

Exact ties in the router's probabilities could be ordered otherwise by
``lax.top_k`` and ``torch.topk``; with random weights there are none, which
the index equality asserts.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.models import moe
from repro_torch.models.layers import Params
from _torch_port import np_, port_config

JCFG = JModelConfig("moe", "moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                    head_dim=8, d_ff=24, n_experts=8, n_shared_experts=1, moe_top_k=2,
                    dtype="float32")
AMPLE = dataclasses.replace(JCFG, capacity_factor=JCFG.n_experts / JCFG.moe_top_k)
CASES = {"ample": AMPLE, "cf1.25": JCFG}
B, S = 2, 24


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.key(seed), jcfg)
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else torch.as_tensor(np.array(v))
                      for k, v in t.items()}
    return jp, Params(tree(jp))


def _x(seed=1, shape=(B, S, 32)):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _reference_slot_tok(jp, x, jcfg, monkeypatch):
    """The (E, C) slot table the reference's ``_moe_block_inner`` gathers
    with, read at its ``jnp.take`` call."""
    seen = []

    def take(a, idx, axis=None, **kw):
        seen.append(np.asarray(idx))
        return jnp.take(a, idx, axis=axis, **kw)

    proxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                     if not n.startswith("__")})
    proxy.take = take
    monkeypatch.setattr(jmoe, "jnp", proxy)
    out = jmoe._moe_block_inner(jp, jnp.asarray(x), jcfg)
    monkeypatch.undo()
    (slot_tok,) = seen
    return slot_tok, np.asarray(out)


def test_route_topk_and_capacity_match_reference():
    logits = np.random.default_rng(0).normal(0, 2, (200, 16)).astype(np.float32)
    for k in (1, 2, 4, 8):
        j_idx, j_w = jmoe.route_topk(jnp.asarray(logits), k)
        idx, w = moe.route_topk(torch.as_tensor(logits), k)
        np.testing.assert_array_equal(np_(idx), np.asarray(j_idx))
        np.testing.assert_allclose(np_(w), np.asarray(j_w), atol=1e-6, rtol=0)
    for T in (1, 3, 4, 6, 10, 48, 100, 4096):
        for k, E, cf in ((2, 8, 1.25), (4, 60, 1.25), (8, 384, 1.25), (2, 8, 4.0),
                         (1, 4, 2.0), (4, 60, 15.0)):
            assert moe._capacity(T, k, E, cf) == jmoe._capacity(T, k, E, cf), (T, k, E, cf)
    # qwen2-moe's served prefill and decode: T = 4096 and T = 4 tokens
    assert moe._capacity(4096, 4, 60, 1.25) == 341 and moe._capacity(4, 4, 60, 1.25) == 4


@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_matches_reference(case, monkeypatch):
    jcfg = CASES[case]
    jp, p = _params(jcfg)
    x = _x()
    ref_slot_tok, _ = _reference_slot_tok(jp, x, jcfg, monkeypatch)
    T, E, k = B * S, jcfg.n_experts, jcfg.moe_top_k
    xt = torch.as_tensor(x).reshape(T, -1)
    C = moe._capacity(T, k, E, jcfg.capacity_factor)
    idx, w, slot_tok, slot_w, slot_of = moe.dispatch(xt @ p["router"], k, C)
    assert slot_tok.shape == ref_slot_tok.shape == (E, C)
    np.testing.assert_array_equal(np_(slot_tok), ref_slot_tok)
    j_idx, _ = jmoe.route_topk(jnp.asarray(x.reshape(T, -1)) @ jp["router"], k)
    np.testing.assert_array_equal(np_(idx), np.asarray(j_idx))
    # each slot holds its token's top-k weight for that expert; empty slots 0
    filled = slot_tok < T
    tok = slot_tok.clamp_max(T - 1)
    rank = (idx[tok] == torch.arange(E)[:, None, None]).int().argmax(dim=-1)
    want = torch.where(filled, w[tok, rank], torch.zeros(()))
    assert torch.equal(slot_w, want)
    # every (token, rank) either holds one slot of its expert or was dropped
    kept = slot_of < E * C
    assert torch.equal(slot_of[kept] // C, idx[kept])
    assert int(kept.sum()) == int(filled.sum())
    if case == "ample":
        assert bool(kept.all())
    else:
        assert int((~kept).sum()) > 0, "the 1.25 case must drop tokens"


@pytest.mark.parametrize("case", list(CASES))
def test_moe_block_matches_reference(case, monkeypatch):
    jcfg = CASES[case]
    jp, p = _params(jcfg)
    x = _x()
    _, ref = _reference_slot_tok(jp, x, jcfg, monkeypatch)
    np.testing.assert_allclose(np.asarray(jmoe.moe_block(jp, jnp.asarray(x), jcfg)), ref,
                               atol=0, rtol=0)
    out = moe.moe_block(p, torch.as_tensor(x), port_config(jcfg))
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(np_(out), ref, atol=1e-5, rtol=0)


def test_moe_block_dense_matches_reference():
    jp, p = _params(JCFG)
    x = _x()
    ref = np.asarray(jmoe.moe_block_dense(jp, jnp.asarray(x), JCFG))
    dense = moe.moe_block_dense(p, torch.as_tensor(x), port_config(JCFG))
    np.testing.assert_allclose(np_(dense), ref, atol=1e-5, rtol=0)
    # with nothing dropped the sparse dispatch computes the oracle's math
    sparse = moe.moe_block(p, torch.as_tensor(x), port_config(AMPLE))
    np.testing.assert_allclose(np_(sparse), np_(dense), atol=1e-5, rtol=0)


def test_chunked_path_matches(monkeypatch):
    jp, p = _params(JCFG)
    x = _x(seed=2, shape=(3, 16, 32))                     # 48 tokens, 3 chunks of 16
    unchunked = moe.moe_block(p, torch.as_tensor(x), port_config(AMPLE))
    monkeypatch.setattr(jmoe, "MOE_CHUNK_TOKENS", 16)
    monkeypatch.setattr(moe, "MOE_CHUNK_TOKENS", 16)
    for jcfg in (JCFG, AMPLE):
        ref = np.asarray(jmoe.moe_block(jp, jnp.asarray(x), jcfg))
        out = moe.moe_block(p, torch.as_tensor(x), port_config(jcfg))
        np.testing.assert_allclose(np_(out), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np_(out), np_(unchunked), atol=1e-6, rtol=0)
