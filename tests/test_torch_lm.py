"""The port's LM slice (models/, configs/, launch/serve.py, convert) against
the reference, on the same weights (``convert.lm_params_from_numpy``).

* forward: the port against the reference's ``lm.forward`` with its Pallas
  kernels in interpret mode, for the smoke configs of every decoder arch
  (dense, moe, ssm, hybrid, vlm) at S = 128 positions in float32: within
  2e-4.
* serving: the port's ``prefill`` + ``decode`` against the reference's at
  ``attn_impl = ssm_impl = "xla"`` (its Pallas prefill returns no cache,
  ROADMAP C2), for the shapes of ``tests/test_serve.py``'s CASES and its vlm
  case: every step's logits and the caches within 1e-4 in float32.
* the serving invariant on the port alone: decode step t reproduces the
  forward logits at position t within 1e-2 (``tests/test_serve.py``).
* the registry, ``smoke_batch`` and ``convert`` against the reference's.
The encoder-decoder family is ``tests/test_torch_encdec.py``'s, the MoE
block ``tests/test_torch_moe.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.configs import smoke_batch as j_smoke_batch
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import encdec, lm
from _port_cases import (SMOKE_ARCHS, batch_n_img, lm_batch, lm_tokens, n_img_of, serve_port,
                         torch_batch)
from _torch_port import np_, port_config, port_lm_params

V = 64
# tests/test_serve.py's CASES and its vlm case (float32, no remat)
SERVE_CASES = [
    JModelConfig("dense", "dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                 head_dim=8, d_ff=64, vocab_size=V, qk_norm=True, remat=False,
                 dtype="float32"),
    JModelConfig("moe", "moe", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                 head_dim=8, d_ff=32, vocab_size=V, n_experts=4, moe_top_k=2,
                 n_shared_experts=1, capacity_factor=4.0, remat=False, dtype="float32"),
    JModelConfig("ssm", "ssm", n_layers=2, d_model=32, vocab_size=V, ssm_state=8,
                 ssm_head_dim=8, ssm_chunk=4, remat=False, dtype="float32"),
    JModelConfig("hybrid", "hybrid", n_layers=4, d_model=32, n_heads=4, n_kv_heads=4,
                 head_dim=8, d_ff=64, vocab_size=V, ssm_state=8, ssm_head_dim=8,
                 ssm_chunk=4, shared_attn_every=2, remat=False, dtype="float32"),
    JModelConfig("vlm", "vlm", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                 head_dim=8, d_ff=64, vocab_size=V, n_img_tokens=4, remat=False,
                 dtype="float32"),
]


def _port(jcfg, seed=0):
    jparams = jlm.init_params(jax.random.key(seed), jcfg)
    cfg = port_config(jcfg)
    return jparams, cfg, port_lm_params(jparams, cfg)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_forward_matches_reference_pallas(arch):
    jcfg = dataclasses.replace(j_get_arch(arch).smoke, dtype="float32",
                               attn_impl="pallas_interpret", ssm_impl="pallas_interpret")
    jparams, cfg, params = _port(jcfg)
    batch = lm_batch(cfg, 2, 128)                     # 128 positions: the Pallas path
    S_out = batch["tokens"].shape[1]
    ref = np.asarray(jlm.forward(jparams, jax.tree.map(jnp.asarray, batch), jcfg))
    out = lm.forward(params, torch_batch(batch), cfg)
    assert out.shape == (2, S_out, jcfg.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(np_(out), ref, atol=2e-4, rtol=0)


def _serve_reference(jparams, jcfg, batch, prompt):
    """Prefill the first ``prompt`` tokens (after the patches, for vlm), then
    decode the rest one by one at positions offset by the patches."""
    toks, n_img = batch["tokens"], batch_n_img(batch)
    extra = {k: jnp.asarray(v) for k, v in batch.items() if k != "tokens"}
    prefill = jax.jit(lambda p, t: jlm.prefill(p, {"tokens": t, **extra}, jcfg,
                                               max_len=toks.shape[1] + n_img))
    decode = jax.jit(lambda p, c, tok, pos: jlm.decode(p, c, tok, pos, jcfg))
    logits, cache = prefill(jparams, jnp.asarray(toks[:, :prompt]))
    outs = [logits[:, 0]]
    for t in range(prompt, toks.shape[1]):
        lg, cache = decode(jparams, cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t + n_img))
        outs.append(lg[:, 0])
    return np.asarray(jnp.stack(outs, axis=1)), cache


@pytest.mark.parametrize("jcfg", SERVE_CASES, ids=[c.name for c in SERVE_CASES])
def test_prefill_decode_match_reference(jcfg):
    jparams, cfg, params = _port(jcfg)
    batch = lm_batch(cfg, 2, 16 + n_img_of(cfg))
    ref, ref_cache = _serve_reference(jparams, jcfg, batch, prompt=8)
    out, cache = serve_port(params, cfg, batch, prompt=8)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    ref_leaves, port_leaves = jax.tree.leaves(ref_cache), jax.tree.leaves(cache)
    assert len(ref_leaves) == len(port_leaves)
    for r, p in zip(ref_leaves, port_leaves):
        assert p.shape == r.shape
        np.testing.assert_allclose(np_(p), np.asarray(r, np.float32), atol=1e-4, rtol=0)


@pytest.mark.parametrize("jcfg", SERVE_CASES, ids=[c.name for c in SERVE_CASES])
def test_decode_matches_forward(jcfg):
    _, cfg, params = _port(jcfg)
    batch = lm_batch(cfg, 2, 16 + n_img_of(cfg))
    full = np_(lm.forward(params, torch_batch(batch), cfg))
    dec, _ = serve_port(params, cfg, batch, prompt=8)
    np.testing.assert_allclose(dec, full[:, 7:, :], atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen2-moe-a2.7b"])
def test_compute_dtype_copy_changes_no_logit(arch):
    """Storing the matmul weights in bf16 once gives the logits of casting
    them at every use (``lm.to_compute_dtype_`` on a tree from ``convert``,
    which comes in ``param_dtype``), and ``init_params``, which stores them
    so as each layer is drawn, gives every leaf that dtype; the MoE router
    and shared-expert gate stay float32."""
    _, cfg, params = _port(j_get_arch(arch).smoke)              # bf16 compute
    toks = {"tokens": torch.as_tensor(lm_tokens(2, 24, cfg.vocab_size))}
    before = lm.forward(params, toks, cfg)
    lm.to_compute_dtype_(params, cfg)
    assert torch.equal(lm.forward(params, toks, cfg), before)
    drawn = lm.init_params(torch.Generator().manual_seed(0), cfg)
    dtypes = lambda p: {name: leaf.dtype for name, leaf in p.named_parameters()}
    assert dtypes(drawn) == dtypes(params)
    layer = drawn["layers"][0]
    if cfg.family == "moe":
        moe = layer["moe"]
        assert moe["e_up"].dtype == moe["shared"]["up"].dtype == torch.bfloat16
        assert moe["router"].dtype == moe["shared"]["shared_gate"].dtype == torch.float32
    else:
        assert layer["in_proj"].dtype == torch.bfloat16
        assert layer["A_log"].dtype == torch.float32


def _stacked(cfg):
    return ("enc_layers", "dec_layers") if cfg.family == "encdec" else ("layers",)


def _restack(params, cfg):
    """The port's params back in the reference's stacked layout (numpy)."""
    def tree(p):
        return {name: (np_(child) if isinstance(child, torch.Tensor) else tree(child))
                for name, child in list(p.named_parameters(recurse=False))
                + list(p.named_children()) if name not in _stacked(cfg)}
    out = tree(params)
    for key in _stacked(cfg):
        per_layer = [tree(lp) for lp in params[key]]
        out[key] = jax.tree.map(lambda *xs: np.stack(xs), *per_layer)
    return out


# shared_attn; lm_head; moe with bf16 params (router float32); encdec
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama3-405b", "kimi-k2-1t-a32b",
                                  "whisper-base"])
def test_convert_round_trips(arch):
    jcfg = j_get_arch(arch).smoke
    if arch == "kimi-k2-1t-a32b":
        jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16", n_shared_experts=1)
    init = jencdec.init_params if jcfg.family == "encdec" else jlm.init_params
    jparams = init(jax.random.key(0), jcfg)
    cfg = port_config(jcfg)
    params = port_lm_params(jparams, cfg)
    back = _restack(params, cfg)
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for r, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, r.astype(np.float32))
    for name, t in params.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        want = torch.float32 if leaf in ("router", "shared_gate") else cfg.param_dtype
        assert t.dtype == want, name


def test_configs_match_reference():
    assert sorted(configs.ARCHS) == sorted(J_ARCHS)
    for arch_id, arch in configs.ARCHS.items():
        ref = j_get_arch(arch_id)
        assert arch.config == port_config(ref.config), arch_id
        assert arch.smoke == port_config(ref.smoke), arch_id
        assert (arch.optimizer, arch.grad_accum, arch.skip_shapes, arch.dp_over_model) == \
            (ref.optimizer, ref.grad_accum, ref.skip_shapes, ref.dp_over_model)
    batch = configs.smoke_batch(configs.get_arch("qwen3-8b").smoke, batch=2, seq=8)
    ref = j_smoke_batch(j_get_arch("qwen3-8b").smoke, batch=2, seq=8)
    np.testing.assert_array_equal(np_(batch["tokens"]), np.asarray(ref["tokens"]))


@pytest.mark.parametrize("arch,seq", [("whisper-base", 32), ("whisper-base", 1500),
                                      ("phi-3-vision-4.2b", 32), ("phi-3-vision-4.2b", 4)])
def test_smoke_batch_matches_reference(arch, seq):
    """The encdec and vlm batches: the same keys, shapes, dtypes and bits
    (bf16 frames and patch embeddings compared as their bit patterns)."""
    cfg = configs.get_arch(arch).config if seq == 1500 else configs.get_arch(arch).smoke
    jcfg = j_get_arch(arch).config if seq == 1500 else j_get_arch(arch).smoke
    batch = configs.smoke_batch(cfg, batch=2, seq=seq, seed=3)
    ref = j_smoke_batch(jcfg, batch=2, seq=seq, seed=3)
    assert list(batch) == list(ref)
    for key, r in ref.items():
        b = batch[key]
        assert tuple(b.shape) == r.shape, key
        if r.dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          np.asarray(r).view(np.int16))
        else:
            assert b.dtype == torch.int32
            np.testing.assert_array_equal(b.numpy(), np.asarray(r))


def test_unported_archs_and_families_raise():
    """Every reference arch resolves (the four last ones included); an unknown
    arch raises; the launcher refuses the multimodal archs, as the
    reference's does; the decoder LM refuses the encdec family."""
    assert sorted(configs.ARCHS) == sorted(J_ARCHS)
    for arch_id in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "phi-3-vision-4.2b",
                    "whisper-base"):
        assert configs.get_arch(arch_id).arch_id == arch_id
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch")
    for arch_id in ("whisper-base", "phi-3-vision-4.2b"):
        with pytest.raises(SystemExit):
            serve.main(["--arch", arch_id, "--device", "cpu"])
    whisper = configs.get_arch("whisper-base").smoke
    with pytest.raises(ValueError, match="encdec"):
        lm.init_params(torch.Generator(), whisper)
    with pytest.raises(ValueError, match="encdec"):
        encdec.init_params(torch.Generator(), configs.get_arch("qwen2-moe-a2.7b").smoke)


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


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"])
def test_serve_main_runs_moe_on_cpu(arch):
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--gen", "4"]
    res = serve.main(argv)
    assert res.ids.shape == (2, 4) and 0 <= int(res.ids.min()) and int(res.ids.max()) < 512
    assert torch.isfinite(res.prefill_logits).all() and torch.isfinite(res.last_logits).all()
    assert torch.equal(serve.main(argv).ids, res.ids)
