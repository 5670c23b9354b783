"""The port's dry-run (``repro_torch.launch.dryrun``) and its parts, against
the JAX package's ``launch/dryrun.py`` and ``configs/base.py``.

* **Specs.** ``input_specs`` / ``decode_operand_specs`` of all 10 archs x 4
  ``SHAPES`` have the reference's shapes and dtypes, the cache leaf by leaf
  (tolerance: none).
* **Mini dry-run.** The reference's own mini dry-run
  (``tests/test_distributed_subprocess.py:90-150``: qwen3-8b,
  qwen2-moe-a2.7b and mamba2-130m smoke configs with remat, train at
  (64 positions, batch 8) in 2 microbatches; qwen3-8b smoke decode at (64, 8);
  a (2, 4) mesh) is compiled in a subprocess on 8 host devices; the port
  traces the same cells on fake tensors over the fake process group.
  Argument bytes per device are equal (the port's decode ``pos`` is an int,
  the reference's a 4-byte int32).  Decode FLOPs are within 1 % of
  ``analyze_hlo``'s (measured: equal).  Train FLOPs are compared after
  taking out, from the formulas, what the port does and the reference's
  ``xla`` path does not: B3's backward recomputes ``_sdpa`` and B4's
  ``_ssd_chunked`` (the reference differentiates its plain forward), B4's
  kernel walks 128-position chunks where ``_ssd_chunked`` walks
  ``cfg.ssm_chunk`` (8), and where the KV heads do not divide the model axis
  (qwen3's 2 over 4) each device projects all of them, where GSPMD
  projects the one its query heads read.  Measured (port less those terms)
  / reference: qwen3-8b 1.0000, qwen2-moe-a2.7b 1.0010, mamba2-130m 1.0000,
  held to those within 1e-5 and to 1 within 0.05.
* **CLI.** One ``ok`` cell and the reference's ``long_500k`` skip.
* **Constraints.** On 8 gloo ranks qwen2-moe-a2.7b's smoke forward
  (logits) and a train step (loss, gradient norm) with the launcher's
  sequence-sharded ``act_shard_spec``, ``moe_ep_shard`` and ``batch_axes``
  equal those without (float32, within
  1e-5 relative: the pins only move data, the sums' order may change); on
  plain tensors they are no-ops.
* **Extrapolation.** ``estimate_cell``'s counts carried from two depths and
  one and two microbatches equal a whole trace's: FLOPs exactly, HBM
  bytes, collective bytes, operations and peak within 2 % (the
  optimizer's per-leaf work and the peak's place are not quite linear).
* **Fakes.** B3's and B4's fake outputs have their plain versions' shapes and
  dtypes at the model shapes, and their FLOP formulas the hand counts.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import decode_operand_specs as j_decode_operand_specs
from repro.configs import input_specs as j_input_specs
from repro.models.config import SHAPES as J_SHAPES
from repro_torch.configs import decode_operand_specs, get_arch, input_specs
from repro_torch.models.config import SHAPES, ShapeSpec
from _torch_port import run_ranks

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ARCH_IDS = sorted(J_ARCHS)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def _jleaf(s):
    return tuple(s.shape), str(s.dtype)


def _leaf(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def _tleaves(tree):
    if isinstance(tree, torch.Tensor):
        return [_leaf(tree)]
    return [x for v in tree for x in _tleaves(v)]


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_specs_equal_the_reference(arch_id):
    jcfg, cfg = J_ARCHS[arch_id].config, get_arch(arch_id).config
    assert [s.name for s in SHAPES] == [s.name for s in J_SHAPES]
    for shape, jshape in zip(SHAPES, J_SHAPES):
        if shape.kind == "decode":
            jcache, jtoken, _, jpos_ref = j_decode_operand_specs(jcfg, jshape)
            cache, token, pos, pos_ref = decode_operand_specs(cfg, shape)
            assert _tleaves(cache) == [_jleaf(s) for s in jax.tree.leaves(jcache)], shape.name
            assert _leaf(token) == _jleaf(jtoken)
            assert pos == pos_ref == jpos_ref and isinstance(pos, int)
            assert all(t.device.type == "meta" for t in [token] + list(jax.tree.leaves(
                cache, is_leaf=lambda x: isinstance(x, torch.Tensor))))
        else:
            jspecs, specs = j_input_specs(jcfg, jshape), input_specs(cfg, shape)
            assert sorted(specs) == sorted(jspecs), shape.name
            for k in specs:
                assert _leaf(specs[k]) == _jleaf(jspecs[k]), (shape.name, k)
                assert specs[k].device.type == "meta"


def test_skip_reasons_equal_the_reference():
    for arch_id in ARCH_IDS:
        for shape in SHAPES:
            assert (get_arch(arch_id).skip_reason(shape.name)
                    == J_ARCHS[arch_id].skip_reason(shape.name)), (arch_id, shape.name)
    assert sum(get_arch(a).skip_reason("long_500k") is not None for a in ARCH_IDS) == 8


# ---------------------------------------------------------------------------
# the mini dry-run against the reference's
# ---------------------------------------------------------------------------

_REFERENCE_MINI = """
    import dataclasses, json, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_mesh
    from repro.launch.hlo_costs import analyze_hlo
    from repro.distributed.sharding import (rules_for, param_specs, opt_state_specs,
                                            batch_specs, cache_specs, tree_shardings)
    from repro.configs import ARCHS, input_specs, decode_operand_specs
    from repro.models.config import ShapeSpec
    from repro.models import lm
    from repro.train.optimizer import make_optimizer, warmup_cosine
    from repro.train.train_step import TrainState, make_train_step, make_serve_step

    mesh = make_mesh((2, 4), ("data", "model"))
    shape = ShapeSpec("mini_train", 64, 8, "train")
    out = {}
    for arch_id in ("qwen3-8b", "qwen2-moe-a2.7b", "mamba2-130m"):
        cfg = dataclasses.replace(ARCHS[arch_id].smoke, remat=True)
        opt = make_optimizer("adamw", warmup_cosine(1e-3))
        state = jax.eval_shape(
            lambda k: TrainState(jnp.zeros((), jnp.int32), lm.init_params(k, cfg),
                                 opt.init(lm.init_params(k, cfg))), jax.random.key(0))
        rules = rules_for(cfg, mesh, "train")
        pspecs = param_specs(state.params, cfg, mesh, rules)
        sspecs = TrainState(P(), pspecs, opt_state_specs(state.opt_state, pspecs,
                                                         state.params, mesh))
        batch = input_specs(cfg, shape)
        bspecs = batch_specs(batch, mesh, rules)
        step = make_train_step(cfg, opt, accum_steps=2)
        with mesh:
            compiled = jax.jit(step, in_shardings=(tree_shardings(sspecs, mesh),
                                                   tree_shardings(bspecs, mesh)),
                               out_shardings=(tree_shardings(sspecs, mesh), None)
                               ).lower(state, batch).compile()
        out[arch_id + "|train"] = [analyze_hlo(compiled.as_text()).flops,
                                   compiled.memory_analysis().argument_size_in_bytes]
    cfg = ARCHS["qwen3-8b"].smoke
    cache, token, pos, _ = decode_operand_specs(cfg, ShapeSpec("mini_decode", 64, 8, "decode"))
    params = jax.eval_shape(lambda k: lm.init_params(k, cfg), jax.random.key(0))
    params = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
                          if jnp.issubdtype(s.dtype, jnp.floating) else s, params)
    rules = rules_for(cfg, mesh, "decode")
    with mesh:
        compiled = jax.jit(make_serve_step(cfg, "decode"), in_shardings=(
            tree_shardings(param_specs(params, cfg, mesh, rules), mesh),
            tree_shardings(cache_specs(cache, cfg, mesh, rules), mesh),
            NamedSharding(mesh, P("data")), NamedSharding(mesh, P()))
        ).lower(params, cache, token, pos).compile()
    out["qwen3-8b|decode"] = [analyze_hlo(compiled.as_text()).flops,
                              compiled.memory_analysis().argument_size_in_bytes]
    print(json.dumps(out))
"""

MINI_CELLS = ("qwen3-8b|train", "qwen2-moe-a2.7b|train", "mamba2-130m|train", "qwen3-8b|decode")
MESH = ((2, 4), ("data", "model"))
N_MB = 2                       # microbatches of the mini train cells


@pytest.fixture(scope="module")
def reference_mini():
    """The reference's mini dry-run, compiled in a subprocess on 8 host
    devices while the port's cells trace."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REFERENCE_MINI)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    result = {}

    def get():
        if not result:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-3000:]
            result.update(json.loads(out.strip().splitlines()[-1]))
        return result
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _port_cell(cell: str):
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import fake_mesh
    arch_id, kind = cell.split("|")
    cfg = dataclasses.replace(get_arch(arch_id).smoke, remat=True)
    with fake_mesh(*MESH) as mesh:
        _, costs, _ = trace_cell(arch_id, ShapeSpec(f"mini_{kind}", 64, 8, kind), mesh,
                                 config=cfg, accum=N_MB if kind == "train" else None,
                                 launcher=False)
    return costs


def _attn_flops(B, H, S, hd):
    return 4 * B * H * S * S * hd


def _ssd_flops(B, H, S, P, N, Q):
    """Products of the chunked SSD at chunk Q (the kernel's formula; the
    reference's ``_ssd_chunked`` einsums count the same at its chunk)."""
    full, rem = divmod(S, Q)
    return B * H * (2 * (N + P) * (full * Q * Q + rem * rem) + 4 * S * P * N)


def _port_only_flops(arch_id: str) -> int:
    """What the port's train step computes beyond the reference's, per device,
    from the formulas (module docstring).  Each device runs each 4-row
    microbatch whole (the reference's microbatches are replicated too) and
    its share of the heads over the model axis of 4."""
    cfg = get_arch(arch_id).smoke
    B, S, n = 8 // N_MB, 64, 4
    if cfg.family == "ssm":
        H, P, N = cfg.ssm_heads // n, cfg.ssm_head_dim, cfg.ssm_state
        kernel = _ssd_flops(B, H, S, P, N, 128)           # bf16 body: 128-position chunks
        ref = _ssd_flops(B, H, S, P, N, min(cfg.ssm_chunk, S))
        # forward and recomputation run the kernel, the backward recomputes
        # _ssd_chunked's forward before its gradient; the reference runs
        # _ssd_chunked four times over
        return N_MB * cfg.n_layers * (2 * kernel - ref)
    extra = N_MB * cfg.n_layers * _attn_flops(B, cfg.n_heads // n, S, cfg.head_dim)
    if cfg.n_kv_heads % n:
        # k and v for every KV head: forward, recomputation, and the two
        # backward products, against the one head GSPMD projects
        T = B * S
        extra += (N_MB * cfg.n_layers * 4 * 2
                  * 2 * T * cfg.d_model * cfg.head_dim * (cfg.n_kv_heads - 1))
    return extra


@pytest.mark.parametrize("cell", MINI_CELLS)
def test_mini_dry_run_against_the_reference(cell, reference_mini):
    costs = _port_cell(cell)
    ref_flops, ref_args = reference_mini()[cell]
    arch_id, kind = cell.split("|")
    if kind == "decode":
        assert costs.argument_bytes + 4 == ref_args          # the reference's int32 pos
        assert costs.flops == pytest.approx(ref_flops, rel=0.01)
        assert costs.flops == ref_flops                       # measured: equal
    else:
        assert costs.argument_bytes == ref_args
        ratio = (costs.flops - _port_only_flops(arch_id)) / ref_flops
        assert ratio == pytest.approx(1.0, abs=0.05), ratio
        assert ratio == pytest.approx({"qwen3-8b": 1.0, "qwen2-moe-a2.7b": 1.000981,
                                       "mamba2-130m": 1.0}[arch_id], abs=1e-5), ratio
    assert costs.peak_bytes > costs.argument_bytes and costs.collective_bytes > 0


def test_estimate_equals_a_whole_trace():
    from repro_torch.launch.dryrun import estimate_cell, trace_cell
    from repro_torch.launch.mesh import fake_mesh
    cfg = dataclasses.replace(get_arch("qwen3-8b").smoke, n_layers=3, remat=True)
    shape = ShapeSpec("mini_train", 64, 12, "train")
    with fake_mesh(*MESH) as mesh:
        _, whole, _ = trace_cell("qwen3-8b", shape, mesh, config=cfg, accum=3)
        _, est, _, traced = estimate_cell("qwen3-8b", shape, mesh, config=cfg, accum=3)
    assert traced == [(1, 1), (1, 2), (2, 1), (2, 2)]
    assert est.flops == whole.flops and est.argument_bytes == whole.argument_bytes
    for field in ("bytes", "collective_bytes", "ops", "peak_bytes"):
        assert getattr(est, field) == pytest.approx(getattr(whole, field), rel=0.02), field


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def test_cli_writes_one_ok_cell_and_the_references_skip(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    for shape in ("decode_32k", "long_500k"):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                            "gemma-2b", "--shape", shape, "--mesh", "single", "--out", str(out)],
                           capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
    cells = json.loads(out.read_text())
    ok = cells["gemma-2b|decode_32k|single"]
    assert ok["status"] == "ok" and ok["mesh"] == "16x16" and ok["n_devices"] == 256
    assert ok["fits_80gb"] is True and ok["trace_s"] >= 0
    assert not {"fits_16gb", "lower_s", "compile_s"} & set(ok)
    assert set(ok["roofline"]) >= {"compute_s", "memory_s", "collective_s", "dominant",
                                   "model_flops_global", "useful_flops_ratio",
                                   "roofline_fraction"}
    assert ok["memory"]["peak_per_device_gb"] * 1e9 == ok["memory"]["peak_bytes"]
    skip = cells["gemma-2b|long_500k|single"]
    assert skip == {"status": "skipped",
                    "reason": J_ARCHS["gemma-2b"].skip_reason("long_500k")}


def test_no_tpu_constant_in_the_dry_run():
    from repro_torch.launch import dryrun
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NET_BW, dryrun.HBM_BYTES) == (
        989e12, 3.35e12, 50e9, 80e9)
    text = (ROOT / "src/repro_torch/launch/dryrun.py").read_text()
    for tpu in ("197e12", "819e9"):
        assert tpu not in text, tpu


# ---------------------------------------------------------------------------
# the launcher-set constraints
# ---------------------------------------------------------------------------


def test_constraints_are_no_ops_on_plain_tensors():
    from repro_torch.models import moe
    from repro_torch.models.layers import pin_act
    from repro_torch.train.train_step import _pin_batch
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").smoke,
                              act_shard_spec=(("data",), "model", None), moe_ep_shard=True)
    x = torch.randn(2, 8, 64)
    assert pin_act(x, cfg) is x and moe._ep(x, cfg) is x
    mb = {"tokens": torch.zeros(4, 8, dtype=torch.int32)}
    assert _pin_batch(mb, (("data", 2), ("model", 4)))["tokens"] is mb["tokens"]


_RANKS_CONSTRAINTS = """
import dataclasses
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_arch, input_specs
from repro_torch.device import make_generator
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.config import ShapeSpec
from repro_torch.train.optimizer import adamw
from repro_torch.train.train_step import TrainState, make_train_step

mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
out = {}
with implicit_replication():
    for arch_id, pins in (("qwen2-moe-a2.7b", dict(act_shard_spec=(("data",), "model", None),
                                                   moe_ep_shard=True)),):
        base = dataclasses.replace(get_arch(arch_id).smoke, dtype=torch.float32)
        init = lambda: lm.init_params(make_generator(0, "cpu"), base, for_training=True)
        params = init()
        rules = sh.rules_for(base, mesh, "train")
        pspecs = sh.param_specs(params, base, mesh, rules)
        toks = torch.randint(0, base.vocab_size, (8, 33), generator=make_generator(1, "cpu"))
        batch = {"tokens": toks[:, :-1].to(torch.int32), "labels": toks[:, 1:].to(torch.int32)}
        dbatch = sh.shard_locally(batch, sh.batch_specs(batch, mesh, rules), mesh)
        res = []
        for cfg, axes in ((base, None), (dataclasses.replace(base, **pins),
                                         (("data", 2), ("model", 4)))):
            params = init()          # a replicated leaf's DTensor shares its storage
            dparams = sh.shard_locally(params, pspecs, mesh)
            logits = lm.forward(dparams, dbatch, cfg).full_tensor()
            opt = adamw(lambda s: 1e-3)
            state = TrainState(torch.zeros((), dtype=torch.int32), dparams,
                               sh.shard_locally(opt.init(params), sh.opt_state_specs(
                                   opt.init(params), pspecs, params, mesh), mesh))
            state, m = make_train_step(cfg, opt, accum_steps=2, batch_axes=axes)(state, dbatch)
            whole = lambda t: float(t.full_tensor() if isinstance(t, DTensor) else t)  # noqa: E731
            res.append((logits, whole(m["loss"]), whole(m["grad_norm"])))
        (l0, s0, g0), (l1, s1, g1) = res
        scale = float(l0.abs().max())
        out[arch_id] = [float((l0 - l1).abs().max()) / scale, abs(s0 - s1) / abs(s0),
                        abs(g0 - g1) / abs(g0)]
if rank == 0:
    print(json.dumps(out))
"""


def test_constraints_equal_the_unpinned_forward_on_8_ranks(tmp_path):
    outs = run_ranks(_RANKS_CONSTRAINTS, 8, tmp_path, timeout=120)
    got = json.loads(outs[0].strip().splitlines()[-1])
    for arch_id, errs in got.items():
        assert max(errs) <= 1e-5, (arch_id, errs)


# ---------------------------------------------------------------------------
# B3's and B4's fakes and FLOP formulas
# ---------------------------------------------------------------------------


def test_kernel_fakes_have_the_plain_versions_shapes_at_model_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_model_ref
    z = get_arch("zamba2-2.7b").config
    k2 = get_arch("kimi-k2-1t-a32b").config
    with FakeTensorMode():
        for dev in ("meta", "cpu"):
            bf = dict(dtype=torch.bfloat16, device=dev)
            for cfg, S in ((z, 4096), (k2, 1024)):
                q = torch.empty(2, S, cfg.n_heads, cfg.head_dim, **bf)
                kv = torch.empty(2, S, cfg.n_kv_heads, cfg.head_dim, **bf)
                o = (flash_attention(q, kv, kv) if dev == "meta"
                     else attention_ref(q, kv, kv))
                assert (o.shape, o.dtype) == (q.shape, q.dtype)
            x = torch.empty(1, 512, z.ssm_heads, z.ssm_head_dim, **bf)
            dt = torch.empty(1, 512, z.ssm_heads, device=dev)
            a = torch.empty(z.ssm_heads, device=dev)
            bm = torch.empty(1, 512, z.ssm_groups, z.ssm_state, **bf)
            y, h = (ssd_scan(x, dt, a, bm, bm, block_q=z.ssm_chunk) if dev == "meta"
                    else ssd_scan_model_ref(x, dt, a, bm, bm))
            assert (y.shape, y.dtype) == (x.shape, x.dtype)
            assert (h.shape, h.dtype) == ((1, z.ssm_heads, z.ssm_head_dim, z.ssm_state),
                                          torch.float32)


def test_kernel_flop_formulas_equal_hand_counts():
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.flash_attention.kernel import flash_attention_flops
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_flops
    # zamba2's train_4k microbatch: 1 x 4096, 32 heads of 80
    assert flash_attention_flops((1, 4096, 32, 80), (1, 4096, 32, 80), None) == (
        2 * 2 * 1 * 32 * 4096 * 4096 * 80)
    # cross-attention: 4 queries over 1500 keys
    assert flash_attention_flops((4, 4, 8, 64), (4, 1500, 8, 64), None) == 4 * 4 * 8 * 4 * 1500 * 64
    x = torch.empty(1, 4096, 80, 64, dtype=torch.bfloat16, device="meta")
    bm = torch.empty(1, 4096, 1, 64, dtype=torch.bfloat16, device="meta")
    # 32 chunks of 128: C B^T and its weighted x per chunk, two state products per position
    per_head = 32 * (2 * 128 * 128 * 64 + 2 * 128 * 128 * 64) + 4096 * 2 * 2 * 64 * 64
    assert ssd_scan_flops(x, None, None, bm, bm, block_q=128) == 80 * per_head
    # a partial last chunk counts its own length; float32 walks chunks of 64
    x32 = torch.empty(2, 100, 4, 16, device="meta")
    b32 = torch.empty(2, 100, 1, 8, device="meta")
    assert ssd_scan_flops(x32, None, None, b32, b32, block_q=128) == 2 * 4 * (
        2 * 24 * (64 * 64 + 36 * 36) + 4 * 100 * 16 * 8)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q = torch.empty(1, 64, 4, 16, dtype=torch.bfloat16, device="meta")
    with FlopCounterMode(display=False) as fc:
        flash_attention(q, q, q)
    assert fc.get_total_flops() == 4 * 4 * 64 * 64 * 16
