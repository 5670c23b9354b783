"""The port's mesh layer (``launch/mesh.py``, ``distributed/sharding.py``) on
the CPU, against the JAX package's ``distributed/sharding.py``.

Meshes are built on the fake process group (one process standing for every
rank).  The reference's specs are computed on a ``jax.sharding.AbstractMesh``
of the same shape and axis names (its rules read only the axis names and
sizes), and, for the (2, 4) mesh, on a real mesh of 8 forced host devices in
a subprocess, as the reference's own test runs.

For every arch (smoke and full configs; full ones as meta tensors in the
port and ``jax.eval_shape`` structs in the reference), every mode (train,
prefill, decode) and the meshes (2, 4), (16, 16) and (2, 16, 16), each
leaf's spec equals the reference's ``PartitionSpec``: params (a per-layer
leaf's spec is the reference's stacked spec without its leading None),
AdamW and Adafactor state (stacked, as the reference's), the batch and the
cache.  Tolerance: none (equal specs).
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import ARCHS as J_ARCHS
from repro.configs import decode_operand_specs, input_specs
from repro.distributed import sharding as jsh
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models.config import ShapeSpec as JShapeSpec
from repro.train import optimizer as jopt
from repro_torch.configs import get_arch
from repro_torch.device import make_generator
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import encdec, lm
from repro_torch.models.layers import KVCache
from repro_torch.train import optimizer as topt
from _torch_port import MetaGenerator, fake_mesh

ARCH_IDS = sorted(J_ARCHS)
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("train", "prefill", "decode")
# the shapes of each mode: the reference's dry-run cells for the full
# configs, its mini dry-run's (64 positions, batch 8) for the smoke ones
SHAPES = {"full": {"train": ("train_4k", 4096, 256), "prefill": ("prefill_32k", 32768, 32),
                   "decode": ("decode_32k", 32768, 128)},
          "smoke": {m: (f"mini_{m}", 64, 8) for m in MODES}}
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _cfgs(arch_id, size):
    j = J_ARCHS[arch_id]
    t = get_arch(arch_id)
    return (j.config, t.config) if size == "full" else (j.smoke, t.smoke)


@functools.lru_cache(maxsize=None)
def _reference_state(arch_id, size):
    jcfg, _ = _cfgs(arch_id, size)
    jmod = jencdec if jcfg.family == "encdec" else jlm
    params = jax.eval_shape(lambda k: jmod.init_params(k, jcfg), jax.random.key(0))
    opts = {name: jax.eval_shape(jopt.make_optimizer(name, lambda s: 1e-3).init, params)
            for name in ("adamw", "adafactor")}
    return params, opts


@functools.lru_cache(maxsize=None)
def _port_state(arch_id, size):
    _, cfg = _cfgs(arch_id, size)
    mod = encdec if cfg.family == "encdec" else lm
    params = mod.init_params(MetaGenerator(), cfg, for_training=True)
    opts = {name: topt.make_optimizer(name, lambda s: 1e-3).init(params)
            for name in ("adamw", "adafactor")}
    return params, opts


def _meta(struct):
    return torch.empty(struct.shape, dtype=getattr(torch, str(struct.dtype)), device="meta")


def _batches(jcfg, cfg, size, mode):
    name, S, B = SHAPES[size][mode]
    shape = JShapeSpec(name, S, B, mode)
    if mode == "decode":
        jcache, token, _, _ = decode_operand_specs(jcfg, shape)
        jbatch = {"t": token}
    else:
        jbatch = input_specs(jcfg, shape)
        jcache = (decode_operand_specs(jcfg, JShapeSpec(name, S, B, "decode"))[0]
                  if mode == "prefill" else None)
    batch = {k: _meta(v) for k, v in jbatch.items()}
    cache = None
    if jcache is not None:
        if cfg.family == "encdec":
            kv = lambda s: torch.zeros((cfg.n_layers, B, s, cfg.n_kv_heads, cfg.head_dim),  # noqa: E731
                                       dtype=cfg.dtype, device="meta")
            S_dec = max(8, S // cfg.dec_ratio)
            cache = encdec.EncDecCache(KVCache(kv(S_dec), kv(S_dec)), KVCache(kv(S), kv(S)))
        else:
            cache = lm.init_cache(cfg, B, S, device="meta")
    return jbatch, jcache, batch, cache


def _jleaves(tree):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def _leaves(tree):
    """A port spec tree's specs in the reference's leaf order (dict keys
    sorted; tuples and lists in order)."""
    if isinstance(tree, tsh.PartitionSpec):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaves(tree[k])]
    return [s for v in tree for s in _leaves(v)]


def _param_leaves(specs):
    """Per reference leaf: the stacked spec of a layer list (every layer's
    spec equal, a None in front), else the spec."""
    def walk(node, stacked):
        if isinstance(node, tsh.PartitionSpec):
            return [(None,) + tuple(node) if stacked else tuple(node)]
        if isinstance(node, list):
            assert all(layer == node[0] for layer in node), "layers' specs differ"
            return walk(node[0], True)
        return [s for k in sorted(node) for s in walk(node[k], stacked)]
    return walk(specs, False)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_specs_equal_the_reference(arch_id, size, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, axes)
    jcfg, cfg = _cfgs(arch_id, size)
    jparams, jopts = _reference_state(arch_id, size)
    params, opts = _port_state(arch_id, size)
    assert tsh.param_count_estimate(cfg) == jsh.param_count_estimate(jcfg)
    with fake_mesh(shape, axes) as mesh:
        assert tsh.data_axes(mesh) == jsh.data_axes(jmesh)
        for mode in MODES:
            jrules = jsh.rules_for(jcfg, jmesh, mode)
            rules = tsh.rules_for(cfg, mesh, mode)
            assert dict(rules) == dict(jrules), mode
            jp = jsh.param_specs(jparams, jcfg, jmesh, jrules)
            pspecs = tsh.param_specs(params, cfg, mesh, rules)
            assert _param_leaves(pspecs) == _jleaves(jp), (mode, "params")
            for name in ("adamw", "adafactor"):
                jo = jsh.opt_state_specs(jopts[name], jp, jparams, jmesh)
                got = tsh.opt_state_specs(opts[name], pspecs, params, mesh)
                assert _leaves(got) == _jleaves(jo), (mode, name)
            jbatch, jcache, batch, cache = _batches(jcfg, cfg, size, mode)
            assert (_leaves(tsh.batch_specs(batch, mesh, rules))
                    == _jleaves(jsh.batch_specs(jbatch, jmesh, jrules))), (mode, "batch")
            if cache is not None:
                assert (_leaves(tsh.cache_specs(cache, cfg, mesh, rules))
                        == _jleaves(jsh.cache_specs(jcache, jcfg, jmesh, jrules))), (mode, "cache")


def test_adafactor_factored_specs_drop_the_reduced_dim():
    """zamba2-2.7b's full config on (16, 16), train: a factored ``vr`` drops the
    last dim's entry and ``vc`` the second to last, on the stacked leaf."""
    params, opts = _port_state("zamba2-2.7b", "full")
    _, cfg = _cfgs("zamba2-2.7b", "full")
    with fake_mesh((16, 16), ("data", "model")) as mesh:
        pspecs = tsh.param_specs(params, cfg, mesh, tsh.rules_for(cfg, mesh, "train"))
        got = tsh.opt_state_specs(opts["adafactor"], pspecs, params, mesh)
    groups = topt.leaf_groups(params)
    in_proj = params["layers"][0]["in_proj"]
    i = next(i for i, g in enumerate(groups) if g.tensors[0] is in_proj)
    assert pspecs["layers"][0]["in_proj"] == ("data", "model")
    assert got["v"][i] == {"vr": (None, "data"), "vc": (None, "model")}


def test_the_references_assertions_hold_for_the_port():
    """``tests/test_distributed_subprocess.py:27-49`` on the port: qwen3-8b's
    smoke config on a (2, 4) mesh, train; the q projection's heads over
    ``model`` (dim 2 of the stacked leaf, dim 1 of the port's per-layer one),
    tokens over ``data``, and the cache's specs resolve (its 2 kv heads do
    not divide the model axis, so the cache shards its sequence)."""
    cfg = get_arch("qwen3-8b").smoke
    params = lm.init_params(MetaGenerator(), cfg)
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        rules = tsh.rules_for(cfg, mesh, "train")
        specs = tsh.param_specs(params, cfg, mesh, rules)
        qspec = specs["layers"][0]["attn"]["q"]
        assert qspec[1] == "model", qspec
        bspecs = tsh.batch_specs({"tokens": torch.empty((8, 16), dtype=torch.int32,
                                                        device="meta")}, mesh, rules)
        assert bspecs["tokens"][0] == "data", bspecs
        cspecs = tsh.cache_specs(lm.init_cache(cfg, 8, 32, device="meta"), cfg, mesh, rules)
        assert cfg.n_kv_heads % 4 and cspecs.k == (None, "data", "model", None, None), cspecs


_REFERENCE_ON_8_DEVICES = """
    import json, jax
    from repro.launch.mesh import make_mesh
    from repro.distributed.sharding import rules_for, param_specs, batch_specs, cache_specs
    from repro.configs import ARCHS, input_specs
    from repro.models.config import ShapeSpec
    from repro.models import lm

    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for arch_id in ("qwen3-8b", "qwen2-moe-a2.7b", "mamba2-130m", "zamba2-2.7b"):
        cfg = ARCHS[arch_id].smoke
        params = jax.eval_shape(lambda k: lm.init_params(k, cfg), jax.random.key(0))
        rules = rules_for(cfg, mesh, "train")
        leaves = jax.tree.leaves(param_specs(params, cfg, mesh, rules),
                                 is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        b = batch_specs(input_specs(cfg, ShapeSpec("mini", 64, 8, "train")), mesh, rules)
        c = cache_specs(jax.eval_shape(lambda: lm.init_cache(cfg, 8, 32)), cfg, mesh, rules)
        out[arch_id] = [[list(map(lambda e: list(e) if isinstance(e, tuple) else e, s))
                         for s in leaves + [b["tokens"]] + jax.tree.leaves(
                             c, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]]
    print(json.dumps(out))
"""


def test_specs_equal_the_reference_on_8_host_devices():
    """The reference's specs on a real (2, 4) mesh of 8 forced host devices
    (a subprocess, as the reference's own test) equal the port's on the
    fake process group: params, batch and cache, train mode."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE_ON_8_DEVICES)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    norm = lambda s: [list(e) if isinstance(e, tuple) else e for s_ in [s] for e in s_]  # noqa: E731
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        for arch_id, (specs,) in want.items():
            cfg = get_arch(arch_id).smoke
            params = lm.init_params(MetaGenerator(), cfg)
            rules = tsh.rules_for(cfg, mesh, "train")
            got = _param_leaves(tsh.param_specs(params, cfg, mesh, rules))
            got.append(tuple(tsh.batch_specs(
                {"tokens": torch.empty((8, 64), device="meta")}, mesh, rules)["tokens"]))
            got += _leaves(tsh.cache_specs(lm.init_cache(cfg, 8, 32, device="meta"), cfg,
                                           mesh, rules))
            assert [norm(s) for s in got] == specs, arch_id


def test_production_meshes_and_placements():
    """The reference's production meshes, and specs as DTensor placements:
    each mesh dim a spec names on tensor dim d is ``Shard(d)``, in mesh-dim
    order; the rest ``Replicate()``."""
    import math
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    for multi_pod, shape, names in ((False, (16, 16), ("data", "model")),
                                    (True, (2, 16, 16), ("pod", "data", "model"))):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
        try:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
            if multi_pod:
                assert tsh.spec_placements(tsh.PartitionSpec(("pod", "data"), None, "model"),
                                           mesh) == (Shard(0), Shard(0), Shard(2))
                assert tsh.spec_placements(tsh.PartitionSpec(None, "data"), mesh) == (
                    Replicate(), Shard(1), Replicate())
            else:
                assert tsh.spec_placements(tsh.PartitionSpec("model", "data"), mesh) == (
                    Shard(1), Shard(0))
                assert tsh.spec_placements(tsh.PartitionSpec(), mesh) == (
                    Replicate(), Replicate())
        finally:
            dist.destroy_process_group()


def test_distribute_tree_places_each_leaf_by_its_spec():
    """A smoke params tree placed on a (2, 4) fake mesh: every leaf a DTensor
    with its spec's placements and the leaf's global shape."""
    cfg = get_arch("qwen3-8b").smoke
    params = lm.init_params(make_generator(0), cfg, for_training=True)
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        specs = tsh.param_specs(params, cfg, mesh, tsh.rules_for(cfg, mesh, "train"))
        placed = tsh.distribute_tree(params, specs, mesh)
        shardings = tsh.tree_shardings(specs, mesh)
        got = dict(placed.named_parameters())
        for name, p in params.named_parameters():
            d = got[name]
            assert isinstance(d.data, DTensor), name
            assert d.shape == p.shape, name
            parts = name.split(".")
            node = shardings
            for key in parts:
                node = node[int(key)] if key.isdigit() else node[key]
            assert tuple(d.data.placements) == node.placements, name
        assert shardings["layers"][0]["attn"]["q"].placements == (Replicate(), Shard(1))
