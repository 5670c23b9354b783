"""The LM slice on a card: every smoke config card = CPU, the served models'
kernel launches per prefill at full width, decode steps that never wait for
the host, and the serving invariant.

* Smoke configs in float32, the same weights and inputs on the card (B3/B4)
  and the CPU (plain versions): forward logits within 1e-4, teacher-forced
  decode = forward within 1e-2, and 8 greedy tokens equal (the encdec
  family included).
* Full width in bf16 with seeded weights, batch 4: zamba2-2.7b and
  qwen2-moe-a2.7b through ``launch.serve.main``, phi-3-vision-4.2b and
  whisper-base through their model entry points, kimi-k2 cut to one layer
  (one layer's experts are 34 GB) through ``serve.generate``.  B3 (and for
  zamba2 B4) launched once per attention (SSM) layer by the prefill and
  never by decode; finite logits; ids in range.  Decode steps under
  ``torch.cuda.set_sync_debug_mode("error")``.
* The serving invariant in float32 (decode step t = forward at t within
  1e-2, atol = rtol): zamba2 and qwen2-moe at full width cut to 12 and 4
  layers (qwen2-moe at capacity factor E / k, so forward drops no token),
  phi-3-vision at full width and 8 layers with patch embeddings,
  whisper-base whole over 1500 frames.

Every case is marked ``cuda`` and skips without a card.  No JAX:

    python -m pytest -q -m cuda tests/test_torch_lm_card.py
"""
import copy
import dataclasses
import gc

import numpy as np
import pytest
import torch

from _card import np_, no_host_sync, requires_cuda, skip_without_cuda
from _port_cases import SMOKE_ARCHS, lm_batch, n_img_of, serve_port, torch_batch
from repro_torch import configs
from repro_torch import kernels as K
from repro_torch.device import make_generator
from repro_torch.launch import serve
from repro_torch.models import encdec, lm

pytestmark = requires_cuda

CARD_CPU_TOL = 1e-4          # float32 logits, card (kernels) against CPU (plain versions)
INVARIANT_TOL = 1e-2         # decode step t against forward at t (tests/test_serve.py)
BATCH, PROMPT, GEN = 4, 1024, 32


@pytest.fixture(autouse=True)
def _free_card():
    """Each full-width model's memory back to the card after its test."""
    yield
    if torch.cuda.is_available():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _randn(shape, seed, dtype=torch.float32, device="cuda"):
    return torch.randn(shape, generator=make_generator(seed, device), device=device, dtype=dtype)


def _randint(high, shape, seed, device="cuda"):
    return torch.randint(0, high, shape, generator=make_generator(seed, device), device=device)


# ---------------------------------------------------------------------------
# smoke configs: card = CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_cuda_forward_and_serving_match_cpu(arch):
    skip_without_cuda()
    cfg = dataclasses.replace(configs.get_arch(arch).smoke, dtype=torch.float32)
    if cfg.family == "moe":          # forward drops no token that decode keeps
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = lm_batch(cfg, 2, 40 + n_img_of(cfg))
    ref = lm.forward(params, torch_batch(batch), cfg)
    out = lm.forward(params.to("cuda"), torch_batch(batch, "cuda"), cfg)
    assert (out.cpu() - ref).abs().max().item() <= 1e-4
    dec, _ = serve_port(params.to("cuda"), cfg, batch, prompt=32, device="cuda")
    np.testing.assert_allclose(dec, np_(ref)[:, 31:, :], atol=1e-2, rtol=1e-2)


def _greedy(prefill, decode, pos0, gen):
    """Greedy ids: the first from ``prefill()``'s last logits, then ``gen - 1``
    decode steps from position ``pos0``."""
    logits, cache = prefill()
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    ids = [tok]
    for i in range(gen - 1):
        logits, cache = decode(cache, tok, pos0 + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        ids.append(tok)
    return torch.cat(ids, dim=1).cpu()


def _smoke_run(cfg, p, inputs):
    """Forward logits (on the CPU) and 8 greedy tokens."""
    if cfg.family == "encdec":
        ids = _greedy(lambda: encdec.prefill(p, {**inputs, "tokens": inputs["tokens"][:, :8]}, cfg,
                                             max_dec_len=16),
                      lambda c, t, pos: encdec.decode(p, c, t, pos, cfg), 8, 8)
        return encdec.forward(p, inputs, cfg).cpu(), ids
    if cfg.family == "vlm":
        n_img = cfg.n_img_tokens
        ids = _greedy(lambda: lm.prefill(p, {**inputs, "tokens": inputs["tokens"][:, :32]}, cfg,
                                         max_len=n_img + 40),
                      lambda c, t, pos: lm.decode(p, c, t, pos, cfg), n_img + 32, 8)
        return lm.forward(p, inputs, cfg).cpu(), ids
    return lm.forward(p, inputs, cfg).cpu(), serve.generate(p, inputs["tokens"][:, :32], cfg,
                                                            8).ids


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                                  "phi-3-vision-4.2b", "whisper-base"])
def test_smoke_greedy_tokens_card_equal_cpu(arch):
    """The same float32 weights and inputs on the card and the CPU: logits
    within 1e-4, 8 greedy tokens equal."""
    skip_without_cuda()
    cfg = dataclasses.replace(configs.get_arch(arch).smoke, dtype=torch.float32)
    if cfg.family == "encdec":
        p_cpu = encdec.init_params(make_generator(0), cfg)
        inputs = {"frames": _randn((2, 64, cfg.d_model), 1, device="cpu"),
                  "tokens": _randint(cfg.vocab_size, (2, 16), 2, device="cpu")}
    else:
        p_cpu = lm.init_params(make_generator(0), cfg)
        inputs = {"tokens": _randint(cfg.vocab_size, (2, 40), 1, device="cpu")}
        if cfg.family == "vlm":
            inputs["patch_embeds"] = _randn((2, cfg.n_img_tokens, cfg.d_model), 2, device="cpu")
    logits_cpu, ids_cpu = _smoke_run(cfg, p_cpu, inputs)
    logits_dev, ids_dev = _smoke_run(cfg, copy.deepcopy(p_cpu).to("cuda"),
                                     {k: v.to("cuda") for k, v in inputs.items()})
    assert (logits_dev - logits_cpu).abs().max().item() <= CARD_CPU_TOL
    assert torch.equal(ids_dev, ids_cpu)


# ---------------------------------------------------------------------------
# full width: launches per prefill, finite logits, no host sync in decode
# ---------------------------------------------------------------------------


def _check_served(res, cfg, launches, want, batch, gen):
    """Launches ``want`` over the whole run (all in the prefill: decode
    launches neither kernel), finite logits, ``gen`` ids a sequence in
    range."""
    assert {k: launches[k] for k in want} == want
    assert torch.isfinite(res.prefill_logits).all() and torch.isfinite(res.last_logits).all()
    assert res.ids.shape == (batch, gen)
    assert 0 <= int(res.ids.min()) and int(res.ids.max()) < cfg.vocab_size


def _argv(arch):
    return ["--arch", arch, "--preset", "full", "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), "--device", "cuda", "--seed", "0"]


def _decode_loop(params, cfg, cache, tok, pos0, steps, model=lm):
    t = tok
    for i in range(steps):
        logits, _ = model.decode(params, cache, t, pos0 + i, cfg)
        t = logits[:, -1].argmax(dim=-1, keepdim=True)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen2-moe-a2.7b"])
def test_serve_main_at_full_width_launches_per_prefill(arch):
    """``serve.main`` at full width: B3 once per attention layer (zamba2's
    shared block every 6 layers) and B4 once per SSM layer in the prefill;
    ``serve.generate`` on weights and prompts drawn from the same seeds gives
    the same tokens; the decode loop under sync-debug "error"."""
    skip_without_cuda()
    cfg = configs.get_arch(arch).config
    K.reset_launch_counts()
    res = serve.main(_argv(arch))
    torch.cuda.synchronize()
    launches = K.launch_counts()
    if cfg.family == "hybrid":
        want = {"flash_attention": cfg.n_layers // cfg.shared_attn_every,
                "ssd_scan": cfg.n_layers}
    else:
        want = {"flash_attention": cfg.n_layers, "ssd_scan": 0}
    _check_served(res, cfg, launches, want, BATCH, GEN)
    params = lm.init_params(make_generator(0, "cuda"), cfg)
    prompts = _randint(cfg.vocab_size, (BATCH, PROMPT), 1)
    assert torch.equal(serve.generate(params, prompts, cfg, GEN).ids, res.ids)
    _, cache = lm.prefill(params, {"tokens": prompts}, cfg, max_len=PROMPT + GEN)
    tok = res.ids[:, :1].to("cuda")
    with no_host_sync():
        _decode_loop(params, cfg, cache, tok, PROMPT, 4)


def test_phi3_vision_at_full_width_launches_per_prefill():
    """256 patch embeddings and 768 text tokens: B3 32 times a prefill, none
    in decode; the decode loop under sync-debug "error"."""
    skip_without_cuda()
    cfg = configs.get_arch("phi-3-vision-4.2b").config
    n_img = cfg.n_img_tokens
    params = lm.init_params(make_generator(0, "cuda"), cfg)
    batch = {"tokens": _randint(cfg.vocab_size, (BATCH, PROMPT - n_img), 1),
             "patch_embeds": _randn((BATCH, n_img, cfg.d_model), 2, dtype=torch.bfloat16)}
    K.reset_launch_counts()
    logits, cache = lm.prefill(params, batch, cfg, max_len=PROMPT + GEN)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == cfg.n_layers
    assert torch.isfinite(logits).all()
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    with no_host_sync():
        _decode_loop(params, cfg, cache, tok, PROMPT, 4)
    assert K.launch_counts()["flash_attention"] == cfg.n_layers


def test_whisper_at_full_width_launches_per_prefill():
    """1500 frames, a 4-token decoder prompt: B3 once per encoder layer and
    twice per decoder layer (self and cross) in the prefill, none in decode;
    the decode loop under sync-debug "error"."""
    skip_without_cuda()
    cfg = configs.get_arch("whisper-base").config
    P = 4
    params = encdec.init_params(make_generator(0, "cuda"), cfg)
    batch = {"frames": _randn((BATCH, 1500, cfg.d_model), 1, dtype=torch.bfloat16),
             "tokens": _randint(cfg.vocab_size, (BATCH, P), 2)}
    K.reset_launch_counts()
    logits, cache = encdec.prefill(params, batch, cfg, max_dec_len=P + 64)
    torch.cuda.synchronize()
    n_b3 = cfg.n_enc_layers + 2 * cfg.n_layers
    assert K.launch_counts()["flash_attention"] == n_b3
    assert torch.isfinite(logits).all()
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    with no_host_sync():
        _decode_loop(params, cfg, cache, tok, P, 4, model=encdec)
    assert K.launch_counts()["flash_attention"] == n_b3


def test_kimi_k2_one_layer_at_full_width():
    """kimi-k2 at full width cut to one layer: one B3 launch a prefill, none
    in decode, through ``serve.generate``."""
    skip_without_cuda()
    cfg = dataclasses.replace(configs.get_arch("kimi-k2-1t-a32b").config, n_layers=1)
    params = lm.init_params(make_generator(0, "cuda"), cfg)
    prompts = _randint(cfg.vocab_size, (BATCH, PROMPT), 1)
    K.reset_launch_counts()
    res = serve.generate(params, prompts, cfg, 16)
    _check_served(res, cfg, K.launch_counts(), {"flash_attention": 1}, BATCH, 16)


# ---------------------------------------------------------------------------
# the serving invariant in float32
# ---------------------------------------------------------------------------


def _assert_invariant(ref, prefill, decode, positions):
    """Teacher-forced decode steps against the forward logits ``ref``."""
    logits, cache = prefill()
    outs = [logits[:, 0]]
    for pos in positions:
        logits, cache = decode(cache, pos)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    assert ((dec - ref).abs() - INVARIANT_TOL * (1 + ref.abs())).max().item() <= 0


@pytest.mark.parametrize("arch,layers", [("zamba2-2.7b", 12), ("qwen2-moe-a2.7b", 4)])
def test_serving_invariant_at_full_width(arch, layers):
    skip_without_cuda()
    full = configs.get_arch(arch).config
    cfg = dataclasses.replace(full, n_layers=layers, dtype=torch.float32)
    if cfg.family == "moe":          # forward over B * S tokens drops none that decode keeps
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)
    params = lm.init_params(make_generator(3, "cuda"), cfg)
    S, prompt = 144, 128
    toks = _randint(cfg.vocab_size, (2, S), 4)
    _assert_invariant(lm.forward(params, {"tokens": toks}, cfg)[:, prompt - 1:],
                      lambda: lm.prefill(params, {"tokens": toks[:, :prompt]}, cfg, max_len=S),
                      lambda c, pos: lm.decode(params, c, toks[:, pos:pos + 1], pos, cfg),
                      range(prompt, S))


def test_serving_invariant_phi3_vision_with_patches():
    skip_without_cuda()
    cfg = dataclasses.replace(configs.get_arch("phi-3-vision-4.2b").config, n_layers=8,
                              dtype=torch.float32)
    params = lm.init_params(make_generator(3, "cuda"), cfg)
    n_img, S, prompt = cfg.n_img_tokens, 144, 128
    toks = _randint(cfg.vocab_size, (2, S), 4)
    patches = _randn((2, n_img, cfg.d_model), 5)
    _assert_invariant(
        lm.forward(params, {"tokens": toks, "patch_embeds": patches}, cfg)[:, prompt - 1:],
        lambda: lm.prefill(params, {"tokens": toks[:, :prompt], "patch_embeds": patches}, cfg,
                           max_len=n_img + S),
        lambda c, pos: lm.decode(params, c, toks[:, pos:pos + 1], n_img + pos, cfg),
        range(prompt, S))


def test_serving_invariant_whisper_over_1500_frames():
    skip_without_cuda()
    cfg = dataclasses.replace(configs.get_arch("whisper-base").config, dtype=torch.float32)
    params = encdec.init_params(make_generator(3, "cuda"), cfg)
    S, prompt = 48, 32
    frames = _randn((2, 1500, cfg.d_model), 4)
    toks = _randint(cfg.vocab_size, (2, S), 5)
    _assert_invariant(
        encdec.forward(params, {"frames": frames, "tokens": toks}, cfg)[:, prompt - 1:],
        lambda: encdec.prefill(params, {"frames": frames, "tokens": toks[:, :prompt]}, cfg,
                               max_dec_len=S),
        lambda c, pos: encdec.decode(params, c, toks[:, pos:pos + 1], pos, cfg),
        range(prompt, S))
