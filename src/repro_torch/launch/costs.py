"""One device's work in a traced step: FLOPs, HBM bytes, collectives and peak
memory, counted beside the trace.  The port's counterpart of the JAX
package's ``launch/hlo_costs.py``, which parses XLA's partitioned HLO text:
the port produces no HLO, so ``hlo_costs.py`` is not ported and these
counters take its role.

``CostCounter`` is a ``TorchDispatchMode`` that sees every op of the step
once, on the tensors one device holds:

* an op on DTensors is passed on (``NotImplemented``), so DTensor runs it
  and the counter sees the local ops it becomes, the collectives of its
  redistributions included.  The op DTensor's sharding propagation runs on
  global-shape fake tensors to learn an output's shape is not counted:
  under a trace on fake tensors it runs in the trace's own fake mode, so
  ``_propagating`` marks it (``MemTracker``'s own test, a fake mode other
  than the one it was entered in, cannot see it there).
  ``FlopCounterMode`` over DTensor code counts that op beside the local
  op (the (8, 64) x (64, 128) product over a (2, 4) mesh: 131,072 + 16,384);
* **FLOPs** come from ``torch.utils.flop_counter``'s formulas, the kernels'
  own included (``repro_torch::flash_attention``, ``repro_torch::ssd_scan``);
  an op without a formula is decomposed where it can be, as
  ``FlopCounterMode`` does;
* **HBM bytes** are each op's inputs plus its outputs (views and metadata
  ops move nothing): an upper bound without fusion, where ``analyze_hlo``
  reads XLA's fused HLO, whose fusions keep their intermediates on chip;
* **collectives** per class (all-reduce, all-gather, reduce-scatter,
  all-to-all, permute), count and bytes, read from the
  ``_c10d_functional`` ops' (and DTensor's ``shard_dim_alltoall``'s)
  outputs with the reference's ring factors: an
  all-reduce moves ``2 n (k - 1) / k``, a permute ``n``, the others
  ``n (k - 1) / k`` of its output's ``n`` bytes over a group of ``k``.
  (``CommDebugMode`` counts them but gives no bytes.)

``trace_costs`` runs a step under it and under
``torch.distributed._tools.mem_tracker.MemTracker``, which follows every
tensor's storage (it works on fake tensors), for the **peak bytes per
device**; the step's operands count from the start, and the propagation's
global-shape outputs do not.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, Iterable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# the kernels' FLOP formulas register when their modules load
from ..kernels.flash_attention import kernel as _fa  # noqa: F401
from ..kernels.ssd_scan import kernel as _ssd  # noqa: F401

__all__ = ["COLLECTIVES", "Costs", "CostCounter", "local_tensors", "tensor_bytes",
           "trace_costs"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "permute")

_aten = torch.ops.aten
_METADATA = {_aten.size.default, _aten.sym_size.int, _aten.stride.default,
             _aten.sym_stride.int, _aten.storage_offset.default, _aten.numel.default,
             _aten.sym_numel.default, _aten.dim.default, _aten.is_contiguous.default,
             _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
             _aten.is_non_overlapping_and_dense.default, _aten.sym_storage_offset.default,
             torch.ops.prim.layout.default, torch.ops.prim.device.default}


_state = threading.local()


def _in_propagation() -> bool:
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def _propagating():
    """Mark the ops DTensor's sharding propagation runs (its
    ``_propagate_tensor_meta_non_cached``) while the context is open."""
    prop = DTensor._op_dispatcher.sharding_propagator
    orig = getattr(prop, "_propagate_tensor_meta_non_cached", None)
    if orig is None or getattr(orig, "_repro_marked", False):
        yield
        return

    def marked(op_schema):
        _state.depth = getattr(_state, "depth", 0) + 1
        try:
            return orig(op_schema)
        finally:
            _state.depth -= 1
    marked._repro_marked = True
    prop._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached


def _collective(func) -> str | None:
    """The class of a collective op, or None."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "_c10d_functional_autograd", "c10d", "_dtensor"):
        return None
    name = func._overloadpacket.__name__
    if "all_reduce" in name or "allreduce" in name:
        return "all-reduce"
    if "all_gather" in name or "allgather" in name:
        return "all-gather"
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    if name in ("broadcast", "broadcast_", "send", "recv_", "permute_tensor"):
        return "permute"
    return None


def _group_size(args) -> int:
    """The size of the process group a functional collective names (its
    last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = next((a for a in reversed(args) if isinstance(a, str)), None)
    return _resolve_process_group(name).size() if name else 1


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_tensors(tree) -> list:
    """Every tensor leaf of ``tree`` (dicts, lists, tuples, ``Params``) as the
    tensor one device holds: a DTensor's local shard."""
    from ..models.layers import Params
    out = []

    def walk(node):
        if isinstance(node, DTensor):
            out.append(node.to_local())
        elif isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, Params):
            for p in node.parameters():
                walk(p.data if not isinstance(p, DTensor) else p)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(tree)
    return out


class CostCounter(TorchDispatchMode):
    """FLOPs, HBM bytes and collectives of the local ops run under it
    (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collective_bytes = 0.0
        self.collectives = {c: {"count": 0, "bytes": 0.0} for c in COLLECTIVES}
        self._fake_on_entry = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if isinstance(func, torch._ops.HigherOrderOperator) or func in _METADATA:
            return func(*args, **kwargs)
        counted = active_fake_mode() is self._fake_on_entry and not _in_propagation()
        kind = _collective(func)
        if kind is None and counted and func._overloadpacket not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if not counted:
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if kind is not None:
            n = sum(tensor_bytes(t) for t in outs)
            k = max(_group_size(args), 1)
            eff = (2.0 * n * (k - 1) / k if kind == "all-reduce" else
                   float(n) if kind == "permute" else n * (k - 1) / k)
            if func.__name__ != "wait_tensor.default" and "wait" not in packet.__name__:
                self.collectives[kind]["count"] += 1
                self.collectives[kind]["bytes"] += eff
                self.collective_bytes += eff
            return out
        if not func.is_view and "wait" not in packet.__name__:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            self.bytes += sum(tensor_bytes(t) for t in ins) + sum(tensor_bytes(t) for t in outs)
        return out


@dataclasses.dataclass
class Costs:
    flops: int
    bytes: int
    collective_bytes: float
    collectives: Dict[str, Dict[str, float]]
    ops: int
    argument_bytes: int
    peak_bytes: int


def trace_costs(fn: Callable[..., Any], *args, device=None) -> tuple:
    """``fn(*args)`` under ``CostCounter`` and ``MemTracker``.  Returns its
    result and the ``Costs`` of one device: the operands' local bytes
    (``argument_bytes``) and the peak of every tracked storage on
    ``device`` (the operands' local shards count from the start)."""
    operands = local_tensors(args)
    arg_bytes = _unique_bytes(operands)
    mt = _memory_tracker()
    mt.track_external(*operands)
    with _propagating(), mt, CostCounter() as cc:
        out = fn(*args)
    peak = mt.get_tracker_snapshot("peak")
    dev = torch.device(device) if device is not None else (
        operands[0].device if operands else torch.device("cpu"))
    peak_bytes = max((snap.get("Total", 0) for d, snap in peak.items()
                      if d.type == dev.type), default=0)
    return out, Costs(cc.flops, cc.bytes, cc.collective_bytes, cc.collectives, cc.ops,
                      arg_bytes, int(peak_bytes))


def _memory_tracker():
    """A ``MemTracker`` that does not track the propagation's ops."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class _Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _in_propagation() and not any(issubclass(t, DTensor) for t in types):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)
    return _Tracker()


def _unique_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of the distinct tensors in ``tensors``."""
    return sum(tensor_bytes(t) for t in {id(t): t for t in tensors}.values())
