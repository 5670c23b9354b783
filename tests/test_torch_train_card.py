"""Training, the mesh layer and the dry-run on a card.

* The zamba2-2.7b and granite-3-2b smoke configs in float32: three steps of
  two microbatches from the same params on the card and the CPU, loss and
  grad norm within 1e-4 relative, params within 2 lr per step (the most an
  Adam step moves a parameter whose near-zero gradient takes the other sign
  on the other device); B3 and B4 launched in each forward and again in its
  recomputation under remat.
* ``launch.train.main`` at the smoke preset on the card: the subset
  selection through B1 and B2, no kernel's plain version called, finite
  losses, a checkpoint, and a second run that resumes from it, its first
  loss the checkpointed state's on the loader's next batch.
* zamba2-2.7b's published config, uncut, at the reference's ``train_4k``
  length (2 x 4096 positions a step in 2 microbatches, AdamW, remat): it
  fits the card, B3 36 and B4 216 launches a step, finite loss and grad
  norm; and B3 and B4 bit-equal on a second call at that shape (what a
  recomputed forward saves for the backward).
* The mesh layer on one card: a world-size-1 NCCL group and a (1, 1) CUDA
  mesh; zamba2-2.7b's specs all None; ``compressed_psum`` = the int8 round
  trip; ``pmm`` with DTensor operands against ``torch.einsum`` autograd; a
  small checkpoint restored onto the mesh.
* The dry-run on that mesh: zamba2-2.7b's train_4k_card and prefill_card
  estimated on fake tensors, then built and run for real under the same
  FLOP counter (peak within 15 %, FLOPs within 1e-6, launches, no plain
  version); and train_4k traced on the (16, 16) production mesh in a
  process of its own.

Every case is marked ``cuda`` and skips without a card.  No JAX:

    python -m pytest -q -m cuda tests/test_torch_train_card.py
"""
import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from _card import requires_cuda, skip_without_cuda
from repro_torch import kernels as K
from repro_torch.configs import get_arch
from repro_torch.device import make_generator
from repro_torch.models import lm
from repro_torch.train.optimizer import adamw, leaf_groups, make_optimizer, warmup_cosine
from repro_torch.train.train_step import TrainState, make_train_step, xent_loss

pytestmark = requires_cuda

ROOT = Path(__file__).resolve().parents[1]
CARD_CPU_RTOL = 1e-4
SMALL_LR, SMALL_STEPS = 1e-3, 3
# each kernel's plain version (kernels/*/ref.py), watched for calls
PLAIN_VERSIONS = {
    "repro_torch.kernels.entropy.ref": ("masked_histogram_ref",),
    "repro_torch.kernels.gen_dst.ref": ("fused_delta_fitness_ref",),
    "repro_torch.kernels.flash_attention.ref": ("attention_ref",),
    "repro_torch.kernels.ssd_scan.ref": ("ssd_scan_ref", "ssd_scan_model_ref",
                                         "ssd_scan_chunked_ref"),
}


@pytest.fixture(autouse=True)
def _free_card():
    yield
    if torch.cuda.is_available():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class plain_versions_counted:
    """Within the block, every kernel's plain version, wherever a
    ``repro_torch`` module holds it, counts its calls into ``self.calls``."""

    def __enter__(self):
        import importlib
        self.calls, self._patched = {}, []
        for mod_name, names in PLAIN_VERSIONS.items():
            ref = importlib.import_module(mod_name)
            for name in names:
                fn = getattr(ref, name)

                def counted(*args, _fn=fn, _name=name, **kw):
                    self.calls[_name] = self.calls.get(_name, 0) + 1
                    return _fn(*args, **kw)
                holders = [(m, attr) for m in list(sys.modules.values())
                           if getattr(m, "__name__", "").startswith("repro_torch")
                           for attr, val in list(vars(m).items()) if val is fn]
                for m, attr in holders:
                    setattr(m, attr, counted)
                    self._patched.append((m, attr, fn))
        return self

    def __exit__(self, *exc):
        for m, attr, fn in self._patched:
            setattr(m, attr, fn)
        return False


def _kernel_layers(cfg):
    """(attention layers, SSM layers) of one forward."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every, cfg.n_layers
    return cfg.n_layers, 0


# ---------------------------------------------------------------------------
# training steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-3-2b"])
def test_smoke_training_card_equals_cpu(arch):
    skip_without_cuda()
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    base = lm.init_params(make_generator(0), cfg, for_training=True)
    toks = torch.randint(0, cfg.vocab_size, (SMALL_STEPS, 4, 33), generator=make_generator(1))
    opt = adamw(lambda s: SMALL_LR)
    runs = []
    for d in ("cpu", "cuda"):
        params = copy.deepcopy(base).to(d)
        state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
        step = make_train_step(cfg, opt, accum_steps=2)
        K.reset_launch_counts()
        metrics = []
        for s in range(SMALL_STEPS):
            batch = {"tokens": toks[s, :, :-1].to(d), "labels": toks[s, :, 1:].to(d)}
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, K.launch_counts(), leaf_groups(state.params)))
    (m_cpu, _, g_cpu), (m_dev, launches, g_dev) = runs
    for (l_d, n_d), (l_c, n_c) in zip(m_dev, m_cpu):
        assert abs(l_d - l_c) <= CARD_CPU_RTOL * abs(l_c)
        assert abs(n_d - n_c) <= CARD_CPU_RTOL * abs(n_c)
    p_err = max((a.value().cpu() - b.value()).abs().max().item() for a, b in zip(g_dev, g_cpu))
    assert p_err <= 2 * SMALL_LR * SMALL_STEPS
    n_attn, n_ssd = _kernel_layers(cfg)
    # 2 microbatches a step; under remat each forward runs again in the backward
    per = 2 * SMALL_STEPS * (2 if cfg.remat else 1)
    assert (launches["flash_attention"], launches["ssd_scan"]) == (per * n_attn, per * n_ssd)


def _step_lines(text):
    """(step, loss, grad norm) of each ``step N loss L gnorm G T ms/step`` line."""
    out = []
    for line in text.splitlines():
        f = line.split()
        if len(f) == 8 and f[0] == "step" and f[2] == "loss" and f[4] == "gnorm":
            out.append((int(f[1]), float(f[3]), float(f[5])))
    return out


def test_train_launcher_selects_trains_checkpoints_and_resumes(tmp_path):
    """The launcher at the smoke preset: 4 sequences of 32 positions a step
    in 2 microbatches, a 512-sequence corpus cut to 128 by Gen-DST, a
    checkpoint after step 3; then 6 steps resume at step 4."""
    skip_without_cuda()
    from repro_torch.data.pipeline import (
        LoaderState, ShardedLoader, SyntheticCorpus, select_corpus_subset,
    )
    from repro_torch.launch import train
    cfg = get_arch("zamba2-2.7b").smoke
    batch, seq, accum, steps = 4, 32, 2, 4
    argv = ["--arch", "zamba2-2.7b", "--batch", str(batch), "--seq", str(seq), "--accum",
            str(accum), "--corpus-seqs", "512", "--substrat-subset", "128", "--ckpt-every", "4",
            "--log-every", "1", "--device", "cuda", "--seed", "0", "--ckpt-dir", str(tmp_path)]

    def run(n):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            state = train.main(argv + ["--steps", str(n)])
        torch.cuda.synchronize()
        return state, buf.getvalue()
    K.reset_launch_counts()
    with plain_versions_counted() as plain:
        state, text = run(steps)
    launches = K.launch_counts()
    assert not plain.calls
    logged = _step_lines(text)
    assert [s for s, _, _ in logged] == list(range(steps)) and int(state.step) == steps
    assert all(math.isfinite(v) for _, l, g in logged for v in (l, g))
    assert launches["masked_histogram"] > 0 and launches["fused_delta_fitness"] > 0
    n_attn, n_ssd = _kernel_layers(cfg)
    fwd = accum * (2 if cfg.remat else 1)
    assert (launches["flash_attention"], launches["ssd_scan"]) == (
        fwd * n_attn * steps, fwd * n_ssd * steps)

    # the loss the resumed run must log first: the checkpointed state (this
    # one) on the loader's batch at step 4, from the launcher's corpus and subset
    corpus = SyntheticCorpus(512, seq + 1, cfg.vocab_size, seed=0)
    subset = select_corpus_subset(corpus, 128, generator=make_generator(0, "cuda"),
                                  sample_rows=512, device="cuda")
    loader = ShardedLoader(corpus, batch, seed=0, subset=subset)
    loader.restore(LoaderState(steps))
    nxt = {k: torch.as_tensor(v, device="cuda").chunk(accum) for k, v in loader.next().items()}
    with torch.no_grad():
        want = sum(float(xent_loss(lm.forward(state.params, {"tokens": t}, cfg), lab))
                   for t, lab in zip(nxt["tokens"], nxt["labels"])) / accum
    state, text = run(steps + 2)
    resumed = _step_lines(text)
    assert f"[ckpt] resumed from step {steps - 1}" in text
    assert [s for s, _, _ in resumed] == [steps, steps + 1] and int(state.step) == steps + 2
    assert abs(resumed[0][1] - want) <= 1e-3        # the log prints 4 decimals


def test_train_4k_at_full_width_fits_and_launches(tmp_path):
    """zamba2-2.7b's published config at 2 x 4096 positions a step (the
    reference's global batch cut for one card): two steps with remat under
    80 GiB, B3 and B4 in each microbatch's forward and its recomputation."""
    skip_without_cuda()
    from repro_torch.train.train_step import init_train_state
    arch = get_arch("zamba2-2.7b")
    full = arch.config
    assert full.remat
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.peak_lr, warmup=20, total=100))
    state = init_train_state(make_generator(0, "cuda"), full, opt)
    step_fn = make_train_step(full, opt, accum_steps=2)
    toks = torch.randint(0, full.vocab_size, (2, 4097), generator=make_generator(6, "cuda"),
                         device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    for _ in range(2):
        state, m = step_fn(state, batch)
        assert math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
    launches = K.launch_counts()
    n_attn, n_ssd = _kernel_layers(full)
    assert (launches["flash_attention"], launches["ssd_scan"]) == (2 * 4 * n_attn, 2 * 4 * n_ssd)
    assert torch.cuda.max_memory_allocated() < 80e9


def test_second_call_is_bit_equal_at_train_4k():
    """B3 and B4 give bit-equal outputs on a second call with the same
    inputs at zamba2-2.7b's train_4k shape (one 4096-position microbatch,
    bf16): what a recomputed forward under remat saves for the backward."""
    skip_without_cuda()
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    full = get_arch("zamba2-2.7b").config
    S, bf16 = 4096, torch.bfloat16
    g = make_generator(7, "cuda")
    q, k, v = (torch.randn(1, S, full.n_heads, full.head_dim, generator=g, device="cuda",
                           dtype=bf16) for _ in range(3))
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       flash_attention(q, k, v, causal=True))
    Hs, P, N = full.ssm_heads, full.ssm_head_dim, full.ssm_state
    x = torch.randn(1, S, Hs, P, generator=g, device="cuda", dtype=bf16)
    dt = torch.rand(1, S, Hs, generator=g, device="cuda") * 0.1
    a = -torch.rand(Hs, generator=g, device="cuda")
    bm, cm = (torch.randn(1, S, full.ssm_groups, N, generator=g, device="cuda", dtype=bf16)
              for _ in range(2))
    y1, h1 = ssd_scan(x, dt, a, bm, cm, block_q=full.ssm_chunk)
    y2, h2 = ssd_scan(x, dt, a, bm, cm, block_q=full.ssm_chunk)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


# ---------------------------------------------------------------------------
# the mesh layer and the dry-run on one card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    """A world-size-1 NCCL process group and a (1, 1) (data, model) CUDA
    mesh, destroyed after the module."""
    skip_without_cuda()
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


def test_zamba2_specs_on_a_one_card_mesh_are_none(mesh):
    """Params, AdamW and Adafactor state and cache specs in every mode: all
    None (``_sanitize`` drops size-1 axes)."""
    skip_without_cuda()
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.optimizer import adafactor

    class MetaGenerator(torch.Generator):
        """Reports the meta device: ``init_params`` then builds shapes only."""

        @property
        def device(self):
            return torch.device("meta")
    full = get_arch("zamba2-2.7b").config
    params = lm.init_params(MetaGenerator(), full, for_training=True)
    for mode in ("train", "prefill", "decode"):
        rules = sh.rules_for(full, mesh, mode)
        pspecs = sh.param_specs(params, full, mesh, rules)
        trees = [pspecs] + [sh.opt_state_specs(opt.init(params), pspecs, params, mesh)
                            for opt in (adamw(lambda s: 1e-3), adafactor(lambda s: 1e-3))]
        trees.append(sh.cache_specs(lm.init_cache(full, 4, 4096, device="meta"), full, mesh,
                                    rules))
        specs = []
        for tree in trees:
            sh._map_specs(tree, specs.append)
        assert specs and not [sp for sp in specs if any(e is not None for e in sp)], mode


def test_compressed_psum_is_the_int8_round_trip(mesh):
    skip_without_cuda()
    from repro_torch.distributed.compression import (
        compressed_psum, dequantize_int8, quantize_int8,
    )
    x = torch.randn(1 << 20, generator=make_generator(8, "cuda"), device="cuda")
    got = compressed_psum(x)
    q, sc = quantize_int8(x.reshape(1, -1))
    q2, s2 = quantize_int8((q.float() * sc).sum(0))
    assert torch.equal(got, dequantize_int8(q2, s2))
    assert float((got - x).abs().max() / x.abs().max()) < 0.05


@pytest.mark.parametrize("subs,xs,ws,spec", [
    ("bsd,df->bsf", (1, 4096, 2560), (2560, 10240), ("data", "model")),        # MLP up
    ("bsd,dhk->bshk", (1, 4096, 2560), (2560, 32, 80), ("data", "model", None)),  # q proj
])
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 1e-2), ("float32", 1e-5)])
def test_pmm_on_dtensors_matches_einsum_autograd(mesh, subs, xs, ws, spec, dtype, tol):
    """``pmm`` at zamba2-2.7b's projections: y, dx and dW within ``tol`` of
    the largest magnitude of ``torch.einsum`` autograd's; dW in its spec's
    placements."""
    skip_without_cuda()
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.pmm import matmul
    td = getattr(torch, dtype)
    gen = make_generator(9, "cuda")
    xv = torch.randn(xs, generator=gen, device="cuda").to(td)
    wv = (torch.randn(ws, generator=gen, device="cuda") * xs[-1] ** -0.5).to(td)
    xd = distribute_tensor(xv, mesh, sh.spec_placements(("data",), mesh)).requires_grad_()
    wd = distribute_tensor(wv, mesh, sh.spec_placements(spec, mesh)).requires_grad_()
    y = matmul(xd, wd, subs, (spec, 1, 1, None))
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(td)
    y.backward(distribute_tensor(gy, mesh, list(y.placements)))
    xr, wr = xv.clone().requires_grad_(), wv.clone().requires_grad_()
    yr = torch.einsum(subs, xr, wr)
    yr.backward(gy)
    for a, b in ((y, yr), (xd.grad, xr.grad), (wd.grad, wr.grad)):
        err = (a.detach().full_tensor().float() - b.detach().float()).abs().max()
        assert float(err / b.detach().float().abs().max()) <= tol
    assert isinstance(wd.grad, DTensor)
    assert tuple(wd.grad.placements) == sh.spec_placements(spec, mesh)


def test_restore_resharded_onto_the_card_mesh(mesh, tmp_path):
    skip_without_cuda()
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.train_step import init_train_state
    smoke = dataclasses.replace(get_arch("zamba2-2.7b").smoke, dtype=torch.float32)
    state = init_train_state(make_generator(0), smoke, adamw(lambda s: 1e-3))
    ckpt.save_checkpoint(tmp_path, 3, state)
    rules = sh.rules_for(smoke, mesh, "train")
    pspecs = sh.param_specs(state.params, smoke, mesh, rules)
    specs = TrainState(sh.PartitionSpec(), pspecs,
                       sh.opt_state_specs(state.opt_state, pspecs, state.params, mesh))
    restored, step = ckpt.restore_resharded(tmp_path, state, sh.tree_shardings(specs, mesh))
    saved, got = [], []
    ckpt._flatten(state, saved)
    ckpt._flatten(restored, got)
    assert step == 3 and len(saved) == len(got)
    for s, g in zip(saved, got):
        assert isinstance(g, DTensor) and g.device.type == "cuda"
        assert torch.equal(g.full_tensor().cpu(), s)


@pytest.mark.parametrize("name,seq,batch,kind,want", [
    ("train_4k_card", 4096, 2, "train", {"flash_attention": 36, "ssd_scan": 216}),
    ("prefill_card", 1024, 4, "prefill", {"flash_attention": 9, "ssd_scan": 54}),
])
def test_dryrun_estimate_against_a_real_run(mesh, name, seq, batch, kind, want):
    """``dryrun.run_cell``'s estimate on fake CUDA tensors against the same
    cell built from ``build_cell`` and run once under the same FLOP counter:
    peak within 15 % of ``max_memory_allocated``, FLOPs within 1e-6, the
    kernels' launches, no plain version, finite outputs."""
    skip_without_cuda()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun
    from repro_torch.launch.costs import CostCounter
    from repro_torch.models.config import ShapeSpec
    shape = ShapeSpec(name, seq, batch, kind)
    rec = dryrun.run_cell("zamba2-2.7b", shape, mesh=mesh, verbose=False)
    assert rec.get("status") == "ok", rec
    est_peak, est_flops = rec["memory"]["peak_bytes"], rec["roofline"]["hlo_flops_per_dev"]
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cell = dryrun.build_cell("zamba2-2.7b", shape, mesh, seed=0, device="cuda")
    dryrun.fill_inputs_(cell, seed=17)
    K.reset_launch_counts()
    with plain_versions_counted() as plain, implicit_replication():
        with CostCounter() as cc:
            out = cell.step(*cell.args)
        torch.cuda.synchronize()
    launches = {k: v for k, v in K.launch_counts().items() if k in want}
    peak = torch.cuda.max_memory_allocated() - base

    def whole(x):
        return x.full_tensor() if isinstance(x, DTensor) else x
    if kind == "train":
        vals = torch.stack([whole(out[1]["loss"]).float(), whole(out[1]["grad_norm"]).float()])
    else:
        vals = whole(out[0]).float()
        assert vals.shape == (batch, 1, cell.cfg.vocab_size)
    assert bool(torch.isfinite(vals).all())
    assert launches == want and not plain.calls
    assert abs(est_peak - peak) / peak <= 0.15
    assert abs(est_flops - cc.flops) / cc.flops <= 1e-6


def test_dryrun_traces_the_production_mesh_in_a_subprocess(tmp_path):
    """zamba2-2.7b train_4k on the (16, 16) mesh over a fake process group,
    traced with this machine's torch."""
    skip_without_cuda()
    out_json = tmp_path / "dryrun.json"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "zamba2-2.7b", "--shape", "train_4k", "--mesh", "single", "--force",
                           "--out", str(out_json)], capture_output=True, text=True, timeout=900,
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(out_json.read_text())["zamba2-2.7b|train_4k|single"]
    assert rec["status"] == "ok", rec
