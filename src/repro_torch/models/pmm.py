"""Sharding-aware matmul with a hand-written backward (Megatron-SP
semantics), after the JAX package's ``models/pmm.py``, as a
``torch.autograd.Function``.

``matmul`` pins the production layout explicitly:

  forward   x --(gather seq)--> dot with TP-sharded W --> out TP-sharded
            (pure 'bsd' outputs take the residual activation's spec when
            one is given);
  backward  dx follows the same rule; dW contracts TP-sharded operands so
            the local tile is already TP-sharded, is cast to the weight's
            dtype, and lands in the parameter's (FSDP x TP) layout;
  weights   are un-sharded only over 'data' (the FSDP gather), in their
            storage dtype.

Where the reference constrains a GSPMD layout (``with_sharding_constraint``),
the port redistributes a DTensor to the same spec on its mesh
(``distributed.sharding.spec_placements``); a plain tensor is left as it
is, as on one device.

``meta`` = (dw_spec, data_size, model_size, act_spec): the weight's spec
tuple, the mesh axes' sizes for the divisibility checks, and the residual
activation's spec (or None).  ``meta=None``: the same forward and backward
with no layout pinned.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

__all__ = ["matmul"]


def _split_subs(subscripts: str):
    ins, out = subscripts.split("->")
    a, b = ins.split(",")
    return a, b, out


def _letter_ax(bsub: str, dw_spec) -> dict:
    return {letter: ax for letter, ax in zip(bsub, dw_spec) if ax == "model"}


def _tp_spec(sub: str, shape, letter_ax, data_size: int) -> tuple:
    """'model' on dims mapped to a TP-sharded dW dim; 'data' on the leading
    batch dim (divisibility-checked); None elsewhere."""
    entries = []
    for i, letter in enumerate(sub):
        if letter_ax.get(letter) == "model":
            entries.append("model")
        elif i == 0 and data_size > 1 and shape[0] % data_size == 0:
            entries.append("data")
        else:
            entries.append(None)
    return tuple(entries)


def _constrain(t: torch.Tensor, spec) -> torch.Tensor:
    """``t`` redistributed to ``spec`` on its mesh if it is a DTensor."""
    if not isinstance(t, DTensor):
        return t
    from ..distributed.sharding import spec_placements
    return t.redistribute(t.device_mesh, spec_placements(spec, t.device_mesh))


def _constrain_act(t, sub: str, letter_ax, meta):
    """TP spec if the tensor carries a TP letter; residual act spec if not."""
    dw_spec, data_size, model_size, act_spec = meta
    if any(letter_ax.get(c) == "model" for c in sub):
        return _constrain(t, _tp_spec(sub, t.shape, letter_ax, data_size))
    if act_spec is not None and len(act_spec) == t.dim():
        return _constrain(t, tuple(act_spec))
    return t


def _unshard_data(w, meta):
    """FSDP weight gather in the storage dtype (TP sharding kept)."""
    if meta is None:
        return w
    return _constrain(w, tuple(ax if ax == "model" else None for ax in meta[0]))


class _ShardedMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, subscripts: str, meta):
        ctx.save_for_backward(x, w)
        ctx.subscripts, ctx.meta = subscripts, meta
        if meta is None:
            return torch.einsum(subscripts, x, w.to(x.dtype))
        a, b, o = _split_subs(subscripts)
        la = _letter_ax(b, meta[0])
        if la or isinstance(x, DTensor):
            # gather the (small) activation over seq/model for the TP matmul
            # (over DTensors also without a TP dim: DTensor's einsum cannot
            # fold a sequence-sharded activation into its batch)
            x = _constrain(x, _tp_spec(a, x.shape, la, meta[1]))
        out = torch.einsum(subscripts, x, _unshard_data(w, meta).to(x.dtype))
        return _constrain_act(out, o, la, meta)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        meta = ctx.meta
        a, b, out = _split_subs(ctx.subscripts)
        g = g.to(x.dtype)
        la = _letter_ax(b, meta[0]) if meta is not None else {}
        if meta is not None:
            # g in its TP spec (the reference pins a TP output's gradient so;
            # a residual output's, pinned to the act spec there, is gathered
            # over the sequence too: DTensor's einsum cannot fold a
            # sequence-sharded operand into its batch)
            g = _constrain(g, _tp_spec(out, g.shape, la, meta[1]))
        # dx: contract g with the (storage-dtype, FSDP-gathered) weight
        dx = torch.einsum(f"{out},{b}->{a}", g, _unshard_data(w, meta).to(g.dtype))
        if meta is not None:
            dx = _constrain_act(dx, a, la, meta)
            # x fully gathered on non-TP dims for the dW contraction
            x = _constrain(x, _tp_spec(a, x.shape, la, meta[1]))
        # dW: local tile already TP-sharded; cast to the weight's dtype; lands
        # in the weight's layout
        dw = torch.einsum(f"{a},{out}->{b}", x, g).to(w.dtype)
        if meta is not None and any(ax for ax in meta[0]):
            dw = _constrain(dw, tuple(meta[0]))
        return dx, dw, None, None


def matmul(x: torch.Tensor, w: torch.Tensor, subscripts: str,
           meta: Optional[Tuple] = None) -> torch.Tensor:
    """``einsum(subscripts, x, w)`` with ``w`` in ``x``'s dtype, its gradient
    computed by hand (dW in ``w``'s dtype) and, with ``meta`` and DTensor
    operands, the production layout pinned (module docstring)."""
    return _ShardedMatmul.apply(x, w, subscripts, meta)
