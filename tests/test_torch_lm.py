"""The port's LM slice (models/, configs/, launch/serve.py, convert) against
the reference, on the same weights (``convert.lm_params_from_numpy``).

* forward: the port against the reference's ``lm.forward`` with its Pallas
  kernels in interpret mode, for the dense, ssm and hybrid smoke configs at
  S = 128 in float32: within 2e-4.
* serving: the port's ``prefill`` + ``decode`` against the reference's at
  ``attn_impl = ssm_impl = "xla"`` (its Pallas prefill returns no cache,
  ROADMAP C2), for the shapes of ``tests/test_serve.py``'s CASES less moe:
  every step's logits and the caches within 1e-4 in float32.
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
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import lm
from _torch_port import np_, port_config, port_lm_params, requires_cuda, skip_without_cuda

V = 64
# tests/test_serve.py's CASES less moe (float32, no remat)
SERVE_CASES = [
    JModelConfig("dense", "dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                 head_dim=8, d_ff=64, vocab_size=V, qk_norm=True, remat=False,
                 dtype="float32"),
    JModelConfig("ssm", "ssm", n_layers=2, d_model=32, vocab_size=V, ssm_state=8,
                 ssm_head_dim=8, ssm_chunk=4, remat=False, dtype="float32"),
    JModelConfig("hybrid", "hybrid", n_layers=4, d_model=32, n_heads=4, n_kv_heads=4,
                 head_dim=8, d_ff=64, vocab_size=V, ssm_state=8, ssm_head_dim=8,
                 ssm_chunk=4, shared_attn_every=2, remat=False, dtype="float32"),
]
SMOKE_ARCHS = ["qwen3-8b", "mamba2-130m", "zamba2-2.7b"]      # dense, ssm, hybrid


def _tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _port(jcfg, seed=0):
    jparams = jlm.init_params(jax.random.key(seed), jcfg)
    cfg = port_config(jcfg)
    return jparams, cfg, port_lm_params(jparams, cfg)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_forward_matches_reference_pallas(arch):
    jcfg = dataclasses.replace(j_get_arch(arch).smoke, dtype="float32",
                               attn_impl="pallas_interpret", ssm_impl="pallas_interpret")
    jparams, cfg, params = _port(jcfg)
    toks = _tokens(2, 128, jcfg.vocab_size)
    ref = np.asarray(jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg))
    out = lm.forward(params, {"tokens": torch.as_tensor(toks)}, cfg)
    assert out.shape == (2, 128, jcfg.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(np_(out), ref, atol=2e-4, rtol=0)


def _serve_reference(jparams, jcfg, toks, prompt):
    prefill = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t}, jcfg, max_len=toks.shape[1]))
    decode = jax.jit(lambda p, c, tok, pos: jlm.decode(p, c, tok, pos, jcfg))
    logits, cache = prefill(jparams, jnp.asarray(toks[:, :prompt]))
    outs = [logits[:, 0]]
    for t in range(prompt, toks.shape[1]):
        lg, cache = decode(jparams, cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        outs.append(lg[:, 0])
    return np.asarray(jnp.stack(outs, axis=1)), cache


def _serve_port(params, cfg, toks, prompt):
    toks = torch.as_tensor(toks)
    logits, cache = lm.prefill(params, {"tokens": toks[:, :prompt]}, cfg, max_len=toks.shape[1])
    outs = [logits[:, 0]]
    for t in range(prompt, toks.shape[1]):
        lg, cache = lm.decode(params, cache, toks[:, t:t + 1], t, cfg)
        outs.append(lg[:, 0])
    return np_(torch.stack(outs, dim=1)), cache


@pytest.mark.parametrize("jcfg", SERVE_CASES, ids=[c.name for c in SERVE_CASES])
def test_prefill_decode_match_reference(jcfg):
    jparams, cfg, params = _port(jcfg)
    toks = _tokens(2, 16, V)
    ref, ref_cache = _serve_reference(jparams, jcfg, toks, prompt=8)
    out, cache = _serve_port(params, cfg, toks, prompt=8)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    ref_leaves, port_leaves = jax.tree.leaves(ref_cache), jax.tree.leaves(cache)
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert p.shape == r.shape
        np.testing.assert_allclose(np_(p), np.asarray(r, np.float32), atol=1e-4, rtol=0)


@pytest.mark.parametrize("jcfg", SERVE_CASES, ids=[c.name for c in SERVE_CASES])
def test_decode_matches_forward(jcfg):
    _, cfg, params = _port(jcfg)
    toks = _tokens(2, 16, V)
    full = np_(lm.forward(params, {"tokens": torch.as_tensor(toks)}, cfg))
    dec, _ = _serve_port(params, cfg, toks, prompt=8)
    np.testing.assert_allclose(dec, full[:, 7:, :], atol=1e-2, rtol=1e-2)


def test_compute_dtype_copy_changes_no_logit():
    """Storing the matmul weights in bf16 once gives the logits of casting
    them at every use (``lm.to_compute_dtype_``)."""
    cfg = configs.get_arch("zamba2-2.7b").smoke                 # bf16 compute
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = {"tokens": torch.as_tensor(_tokens(2, 24, cfg.vocab_size))}
    before = lm.forward(params, toks, cfg)
    lm.to_compute_dtype_(params, cfg)
    assert params["layers"][0]["in_proj"].dtype == torch.bfloat16
    assert params["layers"][0]["A_log"].dtype == torch.float32
    assert torch.equal(lm.forward(params, toks, cfg), before)


def _restack(params, cfg):
    """The port's params back in the reference's stacked layout (numpy)."""
    def tree(p):
        return {name: (np_(child) if isinstance(child, torch.Tensor) else tree(child))
                for name, child in list(p.named_parameters(recurse=False))
                + list(p.named_children()) if name != "layers"}
    out = tree(params)
    per_layer = [tree(lp) for lp in params["layers"]]
    out["layers"] = jax.tree.map(lambda *xs: np.stack(xs), *per_layer)
    return out


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama3-405b"])   # shared_attn; lm_head
def test_convert_round_trips(arch):
    jcfg = j_get_arch(arch).smoke
    jparams, cfg, params = _port(jcfg)
    back = _restack(params, cfg)
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for r, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, r)


def test_configs_match_reference():
    for arch_id, arch in configs.ARCHS.items():
        ref = j_get_arch(arch_id)
        assert arch.config == port_config(ref.config), arch_id
        assert arch.smoke == port_config(ref.smoke), arch_id
        assert (arch.optimizer, arch.grad_accum, arch.skip_shapes, arch.dp_over_model) == \
            (ref.optimizer, ref.grad_accum, ref.skip_shapes, ref.dp_over_model)
    batch = configs.smoke_batch(configs.get_arch("qwen3-8b").smoke, batch=2, seq=8)
    from repro.configs import smoke_batch as j_smoke_batch
    ref = j_smoke_batch(j_get_arch("qwen3-8b").smoke, batch=2, seq=8)
    np.testing.assert_array_equal(np_(batch["tokens"]), np.asarray(ref["tokens"]))


def test_unported_archs_and_families_raise():
    for arch_id in configs.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="A11"):
            configs.get_arch(arch_id)
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch")
    moe = port_config(j_get_arch("qwen2-moe-a2.7b").smoke)
    with pytest.raises(NotImplementedError, match="A11"):
        lm.init_params(torch.Generator(), moe)


def test_serve_main_runs_on_cpu():
    argv = ["--arch", "zamba2-2.7b", "--device", "cpu", "--preset", "cpu-small",
            "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    res = serve.main(argv)
    assert res.ids.shape == (2, 4) and res.ids.dtype == torch.int64
    assert int(res.ids.min()) >= 0 and int(res.ids.max()) < 512
    assert torch.isfinite(res.prefill_logits).all() and torch.isfinite(res.last_logits).all()
    assert torch.equal(serve.main(argv).ids, res.ids)           # seeded
    sampled = serve.main(argv + ["--temperature", "1.0", "--arch", "mamba2-130m"])
    assert sampled.ids.shape == (2, 4)


@requires_cuda
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_cuda_forward_and_serving_match_cpu(arch):
    skip_without_cuda()
    cfg = dataclasses.replace(configs.get_arch(arch).smoke, dtype=torch.float32)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.as_tensor(_tokens(2, 40, cfg.vocab_size))
    ref = lm.forward(params, {"tokens": toks}, cfg)
    out = lm.forward(params.to("cuda"), {"tokens": toks.cuda()}, cfg)
    assert (out.cpu() - ref).abs().max().item() <= 1e-4
    dec, _ = _serve_port(params.to("cuda"), cfg, toks.cuda(), prompt=32)
    np.testing.assert_allclose(dec, np_(ref)[:, 31:, :], atol=1e-2, rtol=1e-2)
