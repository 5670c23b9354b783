"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake CUDA
tensors over the fake process group, after the JAX package's
``launch/dryrun.py``.

For each cell this script:
  1. builds the production mesh (16, 16) or (2, 16, 16) as a CUDA mesh on
     the fake process group of 256 or 512 ranks (``launch/mesh.fake_mesh``;
     the reference builds it on 512 host placeholder devices);
  2. resolves the sharding rules and the launcher's per-cell decisions (the
     reference's: ``dp_over_model``, the batch prefix, sequence-sharded
     residuals for big dense/vlm/moe, ``grad_shard``, ``moe_ep_shard``,
     ``accum`` from ``grad_accum``) and builds the cell's operands inside a
     ``FakeTensorMode``: params, optimizer state, batch and caches as
     DTensors whose local tensors are fake (``build_cell``), nothing
     allocated;
  3. runs the cell's step once on them (``run_cell``): the train step with
     its microbatches, forward, recomputation and backward and the
     optimizer, or prefill, or one decode step.  The trace is the step's
     own code, so it shows that the distribution is coherent (every op
     has a sharding, every redistribution a collective) and what one
     device holds;
  4. records one device's FLOPs, HBM bytes, collectives per class and peak
     memory (``launch/costs.py``) and the three roofline terms into
     ``experiments/dryrun_torch.json`` (incremental: a rerun skips completed
     cells, ``--force`` recomputes them).

It computes nothing on any device: the fake tensors have no data, and the
kernels (B3 ``repro_torch::flash_attention``, B4 ``repro_torch::ssd_scan``)
give their outputs' shapes through their fake implementations.  It is no
CPU fallback of anything: the same ``run_cell`` on a card's mesh
(``tests/test_torch_train_card.py``) is held there against a real run of
the cell.

Differences from the reference (ROADMAP): one ``trace_s`` where the
reference reports ``lower_s`` and ``compile_s``; ``fits_80gb`` (an H100's
memory) where it reports ``fits_16gb``; the hardware model is the H100's
(below), not the TPU's; ``pos`` of a decode cell is an int.  Where DTensor
has no sharding strategy for an op, the kernels run through ``local_map``
(``models/layers.local_kernel``) after a redistribution to batch rows and
heads; every other op runs on DTensor's own strategies, whose
redistributions are counted as collectives.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh multi
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch

from ..configs import ARCHS, decode_operand_specs, get_arch, input_specs
from ..distributed.sharding import (
    batch_specs, cache_specs, data_axes, opt_state_specs, param_count_estimate, param_specs,
    rules_for, shard_locally,
)
from ..models import encdec, lm
from ..models.config import SHAPES, ShapeSpec
from ..models.layers import KVCache
from ..train.optimizer import make_optimizer, warmup_cosine
from ..train.train_step import TrainState, make_serve_step, make_train_step
from .costs import Costs, trace_costs
from .flops import model_flops
from .mesh import fake_mesh, production_shape

__all__ = ["PEAK_FLOPS", "HBM_BW", "NET_BW", "HBM_BYTES", "Cell", "build_cell", "roofline",
           "trace_device", "trace_cell", "estimate_cell", "fill_inputs_", "run_cell", "main"]

# hardware model, per H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core
# rate and HBM3 rate, as chip_kernels.py uses them; 80 GB of HBM
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80e9
# both production meshes span nodes of 8 GPUs on every 16-wide axis, so
# every collective crosses InfiniBand: one 400 Gb/s NDR link per GPU
NET_BW = 50e9

OUT_PATH = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch.json"


@dataclasses.dataclass
class Cell:
    """A cell's step and its operands (``args``), with the decisions taken."""
    arch_id: str
    shape: ShapeSpec
    cfg: Any
    step: Callable[..., Any]
    args: tuple
    accum: int = 1


class _FakeGenerator(torch.Generator):
    """A CPU generator that reports the meta device: ``init_params`` draws
    on ``generator.device``, the meta device has no generator of its own,
    and under a ``FakeTensorMode`` nothing is drawn."""

    def __new__(cls, device: str):
        gen = super().__new__(cls)
        gen._device = torch.device(device)
        return gen

    def __init__(self, device: str):
        super().__init__()

    @property
    def device(self):
        return self._device


def _generator(seed: int, device: str):
    if torch.device(device).type == "meta":
        return _FakeGenerator(device).manual_seed(seed)
    from ..device import make_generator
    return make_generator(seed, torch.device(device))


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _serve_dtype_(params) -> None:
    """Every floating param in bf16, as the reference's
    ``_serve_params_struct`` (``dryrun.py:57-67``) serves them."""
    for p in params.parameters():
        if p.is_floating_point():
            p.data = p.data.to(torch.bfloat16)


def _launcher(arch, cfg, shape: ShapeSpec, mesh, rules, accum: Optional[int]):
    """The reference launcher's decisions for a cell (``dryrun.py:72-132``):
    the config with its activation, gradient and expert pins, and the
    microbatch count."""
    sizes = _sizes(mesh)

    def valid_batch_prefix(size: int):
        axes = rules["batch"]
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        names, prod = [], 1
        for a in axes:
            if size % (prod * sizes[a]):
                break
            names.append(a)
            prod *= sizes[a]
        return tuple(names), prod

    pcount = param_count_estimate(cfg)
    if accum is None:
        _, dshards = valid_batch_prefix(shape.global_batch)
        accum = (max(1, min(arch.grad_accum, shape.global_batch // max(dshards, 1)))
                 if shape.kind == "train" else 1)
    if (cfg.family in ("dense", "vlm", "moe") and shape.seq_len % sizes["model"] == 0
            and ((shape.kind == "train" and pcount >= 2e9)
                 or (shape.kind == "prefill" and pcount >= 8e9))):
        # sequence-sharded residuals (Megatron-SP)
        cfg = dataclasses.replace(cfg, act_shard_spec=(data_axes(mesh), "model", None))
    else:
        # pin the residual's batch sharding over the longest prefix of the
        # batch axes that divides the per-call batch (the microbatch in train)
        names, _ = valid_batch_prefix(shape.global_batch // accum)
        if names:
            entry = names[0] if len(names) == 1 else tuple(names)
            cfg = dataclasses.replace(cfg, act_shard_spec=(entry, None, None))
    if (shape.kind == "train" and pcount >= 2e9 and cfg.family in ("dense", "vlm", "moe")
            and cfg.d_model % sizes["model"] == 0 and cfg.d_model % sizes["data"] == 0
            and cfg.d_ff % sizes["model"] == 0):
        cfg = dataclasses.replace(cfg, grad_shard=True, mesh_data_size=sizes["data"],
                                  mesh_model_size=sizes["model"])
    if cfg.family == "moe" and cfg.n_experts % sizes["model"] == 0:
        cfg = dataclasses.replace(cfg, moe_ep_shard=True)
    return cfg, accum


def _with_depth(cfg, layers: Optional[int]):
    """``cfg`` with ``layers`` layers (encdec: as many in each stack)."""
    if layers is None or layers == cfg.n_layers:
        return cfg
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=layers, n_enc_layers=layers)
    return dataclasses.replace(cfg, n_layers=layers)


def build_cell(arch_id: str, shape: ShapeSpec, mesh, *, seed: int = 0,
               device: str = "cuda", config=None, accum: Optional[int] = None,
               launcher: bool = True, layers: Optional[int] = None,
               microbatches: Optional[int] = None) -> Cell:
    """The cell's step and sharded operands on ``mesh`` (the reference's
    ``build_cell``, ``dryrun.py:66-180``).  Inside a ``FakeTensorMode`` every
    operand is fake; outside it they are real tensors drawn from ``seed``
    (params from the arch's init, the rest zeros), each rank keeping its
    chunk of them (``shard_locally``).

    ``config`` and ``accum`` replace the arch's published config and the
    accumulation rule, and ``launcher=False`` leaves out the launcher's
    decisions (``dp_over_model``, the activation, gradient and expert pins,
    ``batch_axes``), as the reference's mini dry-run
    (``tests/test_distributed_subprocess.py:90-150``) builds its cells.
    ``layers`` and ``microbatches`` cut the depth and the number of
    microbatches of the step (each microbatch keeps its rows) after the
    decisions are taken on the whole cell (``estimate_cell``)."""
    arch = get_arch(arch_id)
    cfg = arch.config if config is None else config
    mode = shape.kind
    sizes = _sizes(mesh)
    rules = rules_for(cfg, mesh, mode)
    if launcher:
        if arch.dp_over_model:
            rules["batch"] = tuple(mesh.mesh_dim_names)
        cfg, accum = _launcher(arch, cfg, shape, mesh, rules, accum)
    accum = accum or 1
    cfg = _with_depth(cfg, layers)
    model = encdec if cfg.family == "encdec" else lm
    gen = _generator(seed, device)
    if shape.kind == "train":
        steps = microbatches or accum
        rows = shape.global_batch // accum * steps
        optimizer = make_optimizer(arch.optimizer, warmup_cosine(arch.peak_lr))
        params = model.init_params(gen, cfg, for_training=True)
        opt_state = optimizer.init(params)
        pspecs = param_specs(params, cfg, mesh, rules)
        ospecs = opt_state_specs(opt_state, pspecs, params, mesh)
        state = TrainState(_host_step(), shard_locally(params, pspecs, mesh),
                           shard_locally(opt_state, ospecs, mesh))
        del params, opt_state
        batch = input_specs(cfg, dataclasses.replace(shape, global_batch=rows), device=device)
        batch = shard_locally(batch, batch_specs(batch, mesh, rules), mesh)
        baxes = rules["batch"]
        baxes = (baxes,) if isinstance(baxes, str) else tuple(baxes or ())
        step = make_train_step(cfg, optimizer, accum_steps=steps, batch_axes=(
            tuple((a, sizes[a]) for a in baxes) if launcher else None))
        return Cell(arch_id, shape, cfg, step, (state, batch), accum)

    params = model.init_params(gen, cfg)
    _serve_dtype_(params)
    params = shard_locally(params, param_specs(params, cfg, mesh, rules), mesh)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape, device=device)
        batch = shard_locally(batch, batch_specs(batch, mesh, rules), mesh)
        cache = _prefill_cache(cfg, shape, device)
        cache = shard_locally(cache, cache_specs(cache, cfg, mesh, rules), mesh)
        step = make_serve_step(cfg, "prefill")
        return Cell(arch_id, shape, cfg, step, (params, batch, cache))
    cache, token, pos, _ = decode_operand_specs(cfg, shape, device=device)
    cache = shard_locally(cache, cache_specs(cache, cfg, mesh, rules), mesh)
    token = shard_locally({"t": token}, batch_specs({"t": token}, mesh, rules), mesh)["t"]
    step = make_serve_step(cfg, "decode")
    return Cell(arch_id, shape, cfg, step, (params, cache, token, pos))


def fill_inputs_(cell: Cell, seed: int) -> None:
    """Draw a real cell's model inputs in place from ``seed``: token ids and
    labels below the vocabulary, stub embeddings (``frames``,
    ``patch_embeds``) from N(0, 1).  ``build_cell`` leaves them empty."""
    from torch.distributed.tensor import DTensor
    from ..device import make_generator
    batch = cell.args[1]
    for t in batch.values():
        local = t.to_local() if isinstance(t, DTensor) else t
        gen = make_generator(seed, local.device)
        if local.is_floating_point():
            local.normal_(generator=gen)
        else:
            local.copy_(torch.randint(0, cell.cfg.vocab_size, local.shape, generator=gen,
                                      device=local.device))


def _host_step() -> torch.Tensor:
    """The step counter, a real host tensor even inside a ``FakeTensorMode``
    (the optimizer reads it on the host)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return torch.zeros((), dtype=torch.int32)


def _prefill_cache(cfg, shape: ShapeSpec, device: str):
    """The zero caches prefill fills: ``init_cache`` for the prompt's
    positions, or encdec's self-attention cache of
    ``max(cfg.max_dec_len, S_dec)`` positions (the cross K/V are computed)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family != "encdec":
        return lm.init_cache(cfg, B, S, device=device)
    S_dec = max(8, S // cfg.dec_ratio)
    kv_shape = (cfg.n_layers, B, max(cfg.max_dec_len, S_dec), cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
                   torch.zeros(kv_shape, dtype=cfg.dtype, device=device))


def trace_device() -> str:
    """The device of the trace's fake tensors: ``cuda``, or ``meta`` where
    PyTorch is built without CUDA.  Such a build has no CUDA device guard,
    which autograd (``AccumulateGrad``'s input metadata) and the indexing
    binding take for a CUDA tensor, fake or not, so it cannot trace a train
    step on fake CUDA tensors; a meta tensor has the same shape, dtype and
    strides and routes to the kernels' ops as a CUDA one does."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


def roofline(costs: Costs, n_devices: int, cfg, shape: ShapeSpec) -> dict:
    """The three terms of one device's step on the H100 model, the useful
    FLOPs (``launch/flops``) and the roofline fraction, under the
    reference's keys (``hlo_*`` name the traced counts)."""
    t_compute = costs.flops / PEAK_FLOPS
    t_memory = costs.bytes / HBM_BW
    t_coll = costs.collective_bytes / NET_BW
    mflops = model_flops(cfg, shape)
    t_model = mflops / (n_devices * PEAK_FLOPS)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bound = max(terms.values())
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": max(terms, key=terms.get),
        "model_flops_global": mflops,
        "hlo_flops_per_dev": float(costs.flops),
        "hlo_bytes_per_dev": float(costs.bytes),
        "collective_bytes_per_dev": float(costs.collective_bytes),
        "useful_flops_ratio": mflops / max(costs.flops * n_devices, 1.0),
        "roofline_fraction": t_model / max(bound, 1e-12),
    }


# ---------------------------------------------------------------------------
# tracing cells
# ---------------------------------------------------------------------------


def trace_cell(arch_id: str, shape: ShapeSpec, mesh, *, device: Optional[str] = None,
               **kw) -> tuple:
    """Build the cell on fake tensors on ``device`` (default
    ``trace_device()``; ``build_cell``'s keywords ``kw``) and run its step
    once under the cost counters.  Returns (cell, costs, trace seconds)."""
    device = device or trace_device()
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True), implicit_replication():
        cell = build_cell(arch_id, shape, mesh, device=device, **kw)
        _, costs = trace_costs(cell.step, *cell.args, device=device)
    return cell, costs, time.perf_counter() - t0


def _depths(cfg) -> tuple:
    """The two depths a deep cell is traced at: one and two hybrid groups,
    else one and two layers (encdec: in each stack, which must be as deep
    as the other)."""
    if cfg.family == "hybrid":
        return cfg.shared_attn_every, 2 * cfg.shared_attn_every
    if cfg.family == "encdec" and cfg.n_enc_layers != cfg.n_layers:
        return cfg.n_layers, cfg.n_layers
    return 1, 2


def _lin(v1: float, v2: float, x1: int, x2: int, x: int) -> float:
    return v1 if x1 == x2 else v1 + (v2 - v1) * (x - x1) / (x2 - x1)


def estimate_cell(arch_id: str, shape: ShapeSpec, mesh, *, device: Optional[str] = None,
                  **kw) -> tuple:
    """One device's costs of the whole cell.  A cell no deeper than two
    layers (two hybrid groups) with at most two microbatches is traced
    whole (``trace_cell``).  A deeper one, or one of more microbatches, is
    traced at two depths and, in train, at one and two microbatches, and
    each count is carried to the cell's depth and microbatch count along
    the straight line through them: layers are alike and microbatches are
    alike, so the FLOPs, bytes, collectives and operations of the step are
    bilinear in the two, and its peak, reached in the last microbatch's
    backward, is linear in the depth (taken at two microbatches).  The
    argument bytes are the whole cell's operands.  Returns (the whole
    cell, its costs, trace seconds, the (layers, microbatches) traced)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .costs import _unique_bytes, local_tensors
    device = device or trace_device()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        whole = build_cell(arch_id, shape, mesh, device=device, **kw)
        arg_bytes = _unique_bytes(local_tensors(whole.args))
    L = whole.cfg.n_layers
    L1, L2 = _depths(whole.cfg)
    depths = (L1, L2) if L > L2 else (L,)
    micro = (1, 2) if shape.kind == "train" and whole.accum > 2 else (None,)
    if len(depths) == 1 and micro == (None,):
        _, costs, _ = trace_cell(arch_id, shape, mesh, device=device, **kw)
        return whole, costs, time.perf_counter() - t0, [(L, whole.accum)]
    points = {(d, m): trace_cell(arch_id, shape, mesh, device=device, layers=d,
                                 microbatches=m, **kw)[1]
              for d in depths for m in micro}
    M = whole.accum

    def at(get):
        per_m = [_lin(get(points[depths[0], m]), get(points[depths[-1], m]), depths[0],
                      depths[-1], L) for m in micro]
        return _lin(per_m[0], per_m[-1], micro[0] or 1, micro[-1] or 1, M if micro[0] else 1)

    collectives = {k: {f: at(lambda c, k=k, f=f: c.collectives[k][f]) for f in ("count", "bytes")}
                   for k in points[depths[0], micro[0]].collectives}
    top = micro[-1]
    peak = _lin(points[depths[0], top].peak_bytes, points[depths[-1], top].peak_bytes,
                depths[0], depths[-1], L)
    costs = Costs(round(at(lambda c: c.flops)), round(at(lambda c: c.bytes)),
                  at(lambda c: c.collective_bytes), collectives, round(at(lambda c: c.ops)),
                  arg_bytes, round(peak))
    return whole, costs, time.perf_counter() - t0, [(d, m or M) for d in depths for m in micro]


def run_cell(arch_id: str, shape: ShapeSpec, multi_pod: bool = False, *, mesh=None,
             verbose: bool = True) -> dict:
    """One cell's record (the reference's ``run_cell``): skipped with the
    arch's reason, or traced on ``mesh`` (default: the production mesh on
    the fake process group) with its memory, collectives and roofline."""
    arch = get_arch(arch_id)
    reason = arch.skip_reason(shape.name)
    if reason:
        return {"status": "skipped", "reason": reason}
    if mesh is None:
        with fake_mesh(*production_shape(multi_pod)) as m:
            return run_cell(arch_id, shape, multi_pod, mesh=m, verbose=verbose)
    n_devices = math.prod(mesh.shape)
    cell, costs, trace_s, traced = estimate_cell(arch_id, shape, mesh)
    mem = {
        "argument_bytes": costs.argument_bytes,
        "peak_bytes": costs.peak_bytes,
        "peak_per_device_gb": costs.peak_bytes / 1e9,
    }
    name = "x".join(str(s) for s in mesh.shape)
    result = {
        "status": "ok",
        "mesh": name,
        "n_devices": n_devices,
        "trace_s": round(trace_s, 1),
        "traced": [list(t) for t in traced],
        "accum": cell.accum,
        "act_shard_spec": [list(e) if isinstance(e, tuple) else e
                           for e in cell.cfg.act_shard_spec],
        "grad_shard": cell.cfg.grad_shard,
        "moe_ep_shard": cell.cfg.moe_ep_shard,
        "memory": mem,
        "collectives": {k: v for k, v in costs.collectives.items() if v["count"]},
        "n_ops": costs.ops,
        "roofline": roofline(costs, n_devices, arch.config, shape),
        "fits_80gb": costs.peak_bytes <= HBM_BYTES,
    }
    if verbose:
        r = result["roofline"]
        print(f"  [{name}] {arch_id} x {shape.name}: trace {trace_s:.0f}s, peak "
              f"{mem['peak_per_device_gb']:.2f} GB/dev, compute {r['compute_s'] * 1e3:.2f}ms / "
              f"memory {r['memory_s'] * 1e3:.2f}ms / coll {r['collective_s'] * 1e3:.2f}ms -> "
              f"{r['dominant']}-bound, roofline_frac {r['roofline_fraction']:.3f}", flush=True)
    del cell
    gc.collect()
    return result


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--out", default=str(OUT_PATH))
    args = ap.parse_args(argv)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else {}

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [s for s in SHAPES if args.shape in (None, s.name)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    t_all = time.perf_counter()
    for arch_id in archs:
        for shape in shapes:
            for multi in meshes:
                key = f"{arch_id}|{shape.name}|{'multi' if multi else 'single'}"
                if (key in results and results[key].get("status") in ("ok", "skipped")
                        and not args.force):
                    continue
                print(f"cell {key} ...", flush=True)
                try:
                    results[key] = run_cell(arch_id, shape, multi)
                except Exception as e:  # noqa: BLE001 — record and continue
                    results[key] = {"status": "failed", "error": f"{type(e).__name__}: {e}"}
                    print(f"  FAILED: {type(e).__name__}: {str(e)[:300]}", flush=True)
                out_path.write_text(json.dumps(results, indent=1))
    counts = {st: sum(1 for v in results.values() if v["status"] == st)
              for st in ("ok", "skipped", "failed")}
    print(f"\ndry-run complete: {counts['ok']} ok, {counts['skipped']} skipped, "
          f"{counts['failed']} failed (of {len(results)} cells) in "
          f"{time.perf_counter() - t_all:.0f} s -> {out_path}")
    for k, v in results.items():
        if v["status"] == "failed":
            print(f"  FAIL {k}: {v['error'][:200]}")


if __name__ == "__main__":
    main()
