"""Logical-axis sharding rules (MaxText-style) for params, optimizer state,
batches and caches, after the JAX package's ``distributed/sharding.py``,
onto a ``torch.distributed`` ``DeviceMesh`` and DTensor placements.

Every parameter leaf name maps to a tuple of logical axis names
(``LOGICAL_AXES``, a copy of the reference's table).  A *rule set* maps
logical axes to mesh axes.  Spec resolution sanitizes against the mesh and
the leaf's shape, as the reference's does:

  * an axis is only applied if the dim size is divisible by the mesh axes'
    total size;
  * a mesh axis never appears twice in one spec (first wins).

A spec is a ``PartitionSpec``: per tensor dim, a mesh axis name, a tuple of
names, or None, the reference's ``jax.sharding.PartitionSpec`` entries.
``tree_shardings`` turns each into a ``NamedSharding``: the mesh and one
DTensor placement per mesh dim, ``Shard(d)`` where the spec names that mesh
dim on tensor dim ``d`` and ``Replicate()`` elsewhere; ``distribute_tree``
places a tree of tensors with them.

Layouts that differ from the reference's:

* The port's ``Params`` holds one tensor per layer where the reference
  stacks a leading ``layers`` axis, so a per-layer leaf's spec is the
  reference's stacked spec without its leading entry, which is always None
  (``rules["layers"] = None``).
* The optimizer state keeps the reference's stacked layout
  (``train.optimizer.leaf_groups``), so ``opt_state_specs`` gives each
  stacked entry the stacked spec, a None in front of the layer's.
* Cache leaves are mapped by what they are (a ``KVCache`` field, an
  ``SSMState`` field) rather than by their number of dims.

Rule sets are chosen per (arch, mode): train uses FSDP over ``data`` for
big models and TP over ``model``; serving uses 2D weight sharding for the
big archs so parameters fit without a data-axis replica (DESIGN.md §6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..models.config import ModelConfig
from ..models.layers import KVCache, Params
from ..models.ssm import SSMState
from .checkpoint import _flatten, _unflatten

__all__ = [
    "LOGICAL_AXES", "PartitionSpec", "NamedSharding", "RuleSet", "rules_for", "data_axes",
    "param_count_estimate", "param_specs", "opt_state_specs", "batch_specs", "cache_specs",
    "tree_shardings", "spec_placements", "distribute_tree", "shard_locally",
]

# leaf name -> logical axes (excluding any leading stacked 'layers' dims)
LOGICAL_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / heads
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    # attention
    "q": ("embed", "heads", "head_dim"),
    "k": ("embed", "kv_heads", "head_dim"),
    "v": ("embed", "kv_heads", "head_dim"),
    "out": ("heads", "head_dim", "embed"),
    "q_norm": ("head_dim",),
    "k_norm": ("head_dim",),
    # dense mlp
    "gate": ("embed", "mlp"),
    "up": ("embed", "mlp"),
    "down": ("mlp", "embed"),
    # moe
    "router": ("embed", "experts"),
    "e_gate": ("experts", "embed", "mlp"),
    "e_up": ("experts", "embed", "mlp"),
    "e_down": ("experts", "mlp", "embed"),
    "shared_gate": ("embed", None),
    # ssm
    "in_proj": ("embed", "ssm_inner"),
    "out_proj": ("ssm_inner", "embed"),
    "conv_w": (None, "ssm_conv"),
    "conv_b": ("ssm_conv",),
    "A_log": ("ssm_heads",),
    "D_skip": ("ssm_heads",),
    "dt_bias": ("ssm_heads",),
    "gated_norm": ("ssm_inner",),
    # norms
    "ln1": ("embed",), "ln2": ("embed",), "ln_x": ("embed",),
    "norm": ("embed",), "final_norm": ("embed",), "enc_norm": ("embed",),
}


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec made concrete on a mesh: one DTensor placement per mesh dim."""
    mesh: DeviceMesh
    placements: Tuple[Any, ...]


class RuleSet(dict):
    """logical axis -> mesh axis name | tuple of names | None."""


def _mesh_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def rules_for(cfg: ModelConfig, mesh: DeviceMesh, mode: str) -> RuleSet:
    """Resolve the rule set for an (arch, mode).  mode: train|prefill|decode."""
    dax = data_axes(mesh)
    big = param_count_estimate(cfg) >= 2e9       # FSDP / 2D-sharding threshold

    rules = RuleSet({
        "batch": dax,
        "seq": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_conv": "model",
        "kv_seq": None,
        "embed": None,
        "layers": None,
    })
    if mode == "train":
        # FSDP: shard the embed axis of weights over data for big models
        if big:
            rules["embed"] = dax if len(dax) == 1 else "data"
    else:
        # serving: 2D weight sharding once a TP-only replica stops being
        # cheap (params/bf16 over the model axis > ~a quarter of HBM)
        if big:
            rules["embed"] = "data"
    return rules


def param_count_estimate(cfg: ModelConfig) -> float:
    """Rough parameter count from the config (for rule thresholds)."""
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    if cfg.family in ("dense", "vlm"):
        attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * 2
        mlp = D * cfg.d_ff * (3 if cfg.glu else 2)
        return emb + L * (attn + mlp)
    if cfg.family == "moe":
        attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * 2
        moe = cfg.n_experts * D * cfg.d_ff * 3 + cfg.n_shared_experts * D * cfg.d_ff * 3
        return emb + L * (attn + moe)
    if cfg.family == "ssm":
        blk = D * (2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads)
        return emb + L * (blk + cfg.d_inner * D)
    if cfg.family == "hybrid":
        blk = D * (2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads)
        attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * 2 + D * cfg.d_ff * 3
        return emb + L * (blk + cfg.d_inner * D) + attn
    if cfg.family == "encdec":
        attn = D * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * 2
        mlp = D * cfg.d_ff * (3 if cfg.glu else 2)
        return emb + (cfg.n_enc_layers + L) * (attn + mlp) + L * attn
    return emb


# ---------------------------------------------------------------------------
# spec resolution
# ---------------------------------------------------------------------------


def _axes_size(sizes: Dict[str, int], entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return sizes[entry]
    return math.prod(sizes[a] for a in entry)


def _sanitize(spec_axes, shape, mesh: DeviceMesh) -> PartitionSpec:
    """Apply divisibility + no-duplicate-mesh-axis constraints.

    Tuple entries fall back to the longest prefix whose total size divides
    the dim (e.g. batch=128 over ('data','model')=(16,16) shards over data)."""
    sizes = _mesh_sizes(mesh)
    used = set()
    out = []
    for dim, entry in zip(shape, spec_axes):
        if entry is None:
            out.append(None)
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        names = tuple(a for a in names if a in sizes and a not in used)
        while names:
            size = math.prod(sizes[a] for a in names)
            if size > 1 and dim % size == 0:
                break
            names = names[:-1]
        if not names:
            out.append(None)
            continue
        used.update(names)
        out.append(names[0] if len(names) == 1 else names)
    return P(*out)


def _logical_for_leaf(name: Optional[str], ndim: int) -> Tuple[Optional[str], ...]:
    """A leaf's logical axes, padding leading stacked dims (a per-layer leaf
    of the port's ``Params`` has none)."""
    if name is None or name not in LOGICAL_AXES:
        return (None,) * ndim
    axes = LOGICAL_AXES[name]
    pad = ndim - len(axes)
    if pad < 0:
        return (None,) * ndim
    return ("layers",) * pad + axes


def _named(tree, fn, name=None):
    """``tree`` (a ``Params``, dicts, lists) with ``fn(name, leaf)`` at each
    leaf, ``name`` the leaf's nearest key; ``Params`` become dicts and layer
    lists lists."""
    if isinstance(tree, Params):
        tree = tree.entries()
    if isinstance(tree, dict):
        return {k: _named(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, nn.ModuleList)):
        return [_named(v, fn, name) for v in tree]
    return fn(name, tree)


def param_specs(params: Any, cfg: ModelConfig, mesh: DeviceMesh, rules: RuleSet):
    """Spec tree (nested dicts and lists) of a parameter tree (a ``Params``
    or nested dicts; meta tensors do)."""
    def spec_for(name, leaf):
        logical = _logical_for_leaf(name, leaf.dim())
        entries = [rules.get(ax) if ax else None for ax in logical]
        return _sanitize(entries, tuple(leaf.shape), mesh)
    return _named(params, spec_for)


def _stacked_specs(spec_tree) -> list:
    """The spec of each of the reference's leaves, in ``leaf_groups`` order:
    a layer list stands for a stacked leaf, whose spec is its layers' with a
    None in front for the stack's axis."""
    out = []

    def walk(node, stacked: bool) -> None:
        if isinstance(node, PartitionSpec):
            out.append(P(None, *node) if stacked else node)
        elif isinstance(node, list):
            if stacked:
                raise ValueError("opt_state_specs: a stack inside a stack")
            walk(node[0], True)
        else:
            for k in sorted(node):
                walk(node[k], stacked)

    walk(spec_tree, False)
    return out


def opt_state_specs(opt_state: Any, params_specs: Any, params: Any, mesh: DeviceMesh):
    """Optimizer state: per-leaf lists aligned with the reference's leaves,
    each entry of the stacked shape (``train.optimizer``).

    Adam m/v mirror the (stacked) param spec; Adafactor's factored stats
    drop the reduced dim's sharding."""
    from ..train.optimizer import leaf_groups
    pspecs = _stacked_specs(params_specs)
    groups = leaf_groups(params)
    if len(pspecs) != len(groups):
        raise ValueError(f"opt_state_specs: {len(pspecs)} specs for {len(groups)} leaves")

    def match(st_list):
        out = []
        for st, spec in zip(st_list, pspecs):
            if isinstance(st, dict):   # adafactor leaf state
                d = {}
                for k in st:
                    if k == "vr":
                        d[k] = P(*spec[:-1]) if len(spec) > 0 else P()
                    elif k == "vc":
                        d[k] = P(*(spec[:-2] + spec[-1:])) if len(spec) >= 2 else P()
                    else:
                        d[k] = spec
                out.append(d)
            else:
                out.append(spec)
        return out

    return {k: match(v) for k, v in opt_state.items()}


def batch_specs(batch: Dict[str, torch.Tensor], mesh: DeviceMesh, rules: RuleSet):
    """Shard a batch dict: leading dim = batch, rest replicated (seq etc.)."""
    def spec_for(leaf):
        if leaf.dim() == 0:
            return P()
        entries = [rules.get("batch")] + [None] * (leaf.dim() - 1)
        return _sanitize(entries, tuple(leaf.shape), mesh)
    return {k: spec_for(v) for k, v in batch.items()}


def cache_specs(cache: Any, cfg: ModelConfig, mesh: DeviceMesh, rules: RuleSet):
    """Specs of a cache tree by its leaves' kinds: ``KVCache`` fields (L, B,
    S, K, hd), ``SSMState`` fields conv (L, B, K-1, Cd) and h (L, B, H, P,
    N), in any tuple (the hybrid pair, ``EncDecCache``), as the port's
    models build them."""
    sizes = _mesh_sizes(mesh)

    def kv(leaf):
        # prefer head sharding; if the kv heads don't divide the model axis,
        # shard the SEQUENCE instead (flash-decoding style)
        kv_ax = rules.get("kv_heads")
        ax_size = _axes_size(sizes, kv_ax)
        if kv_ax is not None and leaf.shape[3] % max(ax_size, 1) == 0 and ax_size > 1:
            entries = [None, rules.get("batch"), rules.get("kv_seq"), kv_ax, None]
        else:
            entries = [None, rules.get("batch"), "model", None, None]
        return _sanitize(entries, tuple(leaf.shape), mesh)

    def conv(leaf):
        return _sanitize([None, rules.get("batch"), None, rules.get("ssm_conv")],
                         tuple(leaf.shape), mesh)

    def h(leaf):
        return _sanitize([None, rules.get("batch"), rules.get("ssm_heads"), None, None],
                         tuple(leaf.shape), mesh)

    def walk(node):
        if isinstance(node, KVCache):
            return KVCache(kv(node.k), kv(node.v))
        if isinstance(node, SSMState):
            return SSMState(conv(node.conv), h(node.h))
        if isinstance(node, tuple):
            parts = [walk(v) for v in node]
            return type(node)(*parts) if hasattr(node, "_fields") else tuple(parts)
        raise TypeError(f"cache_specs: {type(node).__name__} is not a cache node")

    return walk(cache)


# ---------------------------------------------------------------------------
# specs onto a mesh
# ---------------------------------------------------------------------------


def spec_placements(spec, mesh: DeviceMesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where ``spec`` names the mesh
    dim on tensor dim ``d``, else ``Replicate()``.  A tensor dim split over
    several mesh dims is split over them in mesh-dim order, as a
    ``PartitionSpec`` tuple entry splits it (the first axis major).  A mesh
    dim of size 1 splits nothing and is ``Replicate()`` (DTensor's views
    refuse some shards over one device)."""
    out = []
    for axis, size in zip(mesh.mesh_dim_names, mesh.shape):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    return tuple(out)


def _map_specs(tree, fn):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(v, fn) for v in tree]
    if isinstance(tree, tuple):
        parts = [_map_specs(v, fn) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def tree_shardings(spec_tree: Any, mesh: DeviceMesh):
    """The spec tree with each spec as a ``NamedSharding`` on ``mesh``."""
    return _map_specs(spec_tree, lambda s: NamedSharding(mesh, spec_placements(s, mesh)))


def distribute_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """``tree`` (a ``Params``, dicts, lists, named tuples of tensors) with
    every leaf a DTensor placed by its spec on ``mesh``; leaves in the
    order ``checkpoint`` walks them."""
    leaves: list = []
    shardings: list = []
    _flatten(tree, leaves)
    _flatten(tree_shardings(specs, mesh), shardings)
    if len(leaves) != len(shardings):
        raise ValueError(f"distribute_tree: {len(shardings)} specs for {len(leaves)} leaves")
    placed = [distribute_tensor(leaf.detach(), sh.mesh, list(sh.placements))
              for leaf, sh in zip(leaves, shardings)]
    return _unflatten(tree, iter(placed))


def _local_shard(t: torch.Tensor, placements, mesh: DeviceMesh) -> DTensor:
    """``t``'s DTensor with this rank's chunk as its local tensor (a copy
    when it is a part), nothing communicated; a tensor dim split over
    several mesh dims is chunked in mesh-dim order, as DTensor splits it."""
    coord = mesh.get_coordinate()
    local = t
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    if local is not t:
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_locally(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """``tree`` with every leaf a DTensor placed by its spec on ``mesh``, each
    rank keeping its own chunk of the full leaf it holds, with no
    communication: for trees every rank draws alike (a seeded init) and for
    fake tensors on the fake process group, where ``distribute_tree``'s
    broadcast cannot run.  Leaves in the order ``checkpoint`` walks them."""
    leaves: list = []
    shardings: list = []
    _flatten(tree, leaves)
    _flatten(tree_shardings(specs, mesh), shardings)
    if len(leaves) != len(shardings):
        raise ValueError(f"shard_locally: {len(shardings)} specs for {len(leaves)} leaves")
    placed = [_local_shard(leaf.detach(), sh.placements, sh.mesh)
              for leaf, sh in zip(leaves, shardings)]
    return _unflatten(tree, iter(placed))
