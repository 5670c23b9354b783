"""Optimizers (AdamW, Adafactor) and the warmup-cosine schedule, after the
JAX package's ``train/optimizer.py``.  Adafactor's factored second moment
keeps optimizer state ~O(rows + cols) for matrices (DESIGN §6).

The reference's param trees stack every layer's leaves, ``(L, ...)``; the
port's ``Params`` holds one tensor per layer.  ``leaf_groups`` walks a tree
in the reference's leaf order and gives each reference leaf as the group of
port tensors it stacks, and the optimizers compute exactly what the
reference computes on the stacked leaf:

* the state keeps the reference's layout: per-leaf lists aligned with the
  reference's leaves, each entry of the stacked shape (a layer's slice is a
  view), so ``convert`` and checkpoints carry it as it is;
* AdamW decays leaves of two or more dims counting the stack's axis
  (``optimizer.py:72``): a stacked norm scale is decayed;
* Adafactor factors over the stacked leaf's trailing two dims, so a stacked
  ``(L, D)`` norm scale keeps one row statistic per layer and a column
  statistic ``(D,)`` shared by the layers; its update clips by the RMS over
  the whole stacked leaf, or over each slice of dim 0 with
  ``scan_update_threshold`` (``:152-162``).

A group whose layers are vectors is stacked for its update (the vectors are
small); a group of matrices is updated layer by layer through views of its
state, the clipping RMS summed over the layers first, so no stacked copy of
the weights is made.

``update(grads, state, params, step)`` writes the new params and state in
place under ``torch.no_grad`` and returns them, where the reference returns
new trees.  The reference's ``_chain_barrier`` (``:39-46``) keeps XLA from
running every leaf's float32 temporaries at once; eager code updates one
leaf after another anyway, so it has no counterpart here.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch import nn

from ..models.layers import Params

__all__ = ["Optimizer", "LeafGroup", "leaf_groups", "adamw", "adafactor", "warmup_cosine",
           "make_optimizer"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, step) -> (params, state), updated in place
    update: Callable[[Any, Any, Any, Any], tuple]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup: int = 200, total: int = 10000, floor: float = 0.1):
    """lr(step) -> float: linear warmup, then a cosine down to ``floor *
    peak_lr``; computed in float32 as the reference's schedule is."""
    def lr(step):
        step = _f32(step)
        warm = peak_lr * (step + 1) / warmup
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return float(torch.where(step < warmup, warm, cos))
    return lr


# ---------------------------------------------------------------------------
# the reference's leaves over the port's per-layer tensors
# ---------------------------------------------------------------------------


class LeafGroup(NamedTuple):
    """One leaf of the reference's tree: the port tensors it stacks (one per
    layer when ``stacked``, else the one tensor)."""
    tensors: List[torch.Tensor]
    stacked: bool

    @property
    def shape(self) -> tuple:
        """The reference leaf's shape."""
        t = self.tensors[0]
        return (len(self.tensors),) + tuple(t.shape) if self.stacked else tuple(t.shape)

    def value(self) -> torch.Tensor:
        """The reference leaf (a stacked copy for a stacked group)."""
        return torch.stack(self.tensors) if self.stacked else self.tensors[0]

    def assign(self, value: torch.Tensor) -> None:
        """Write the reference leaf ``value`` into the port tensors."""
        for i, t in enumerate(self.tensors):
            t.copy_(value[i] if self.stacked else value)


def leaf_groups(tree) -> List[LeafGroup]:
    """The reference's leaves of ``tree`` in its leaf order (dict keys
    sorted, as ``jax.tree`` walks them).  ``tree`` is a ``Params`` or nested
    dicts; a list (``layers``, ``enc_layers``, ``dec_layers``) stands for
    the reference's stacked subtree, each of its leaves the group of the
    layers' tensors."""
    out: List[LeafGroup] = []

    def walk(nodes: list, stacked: bool) -> None:
        first = nodes[0]
        if isinstance(first, torch.Tensor):
            out.append(LeafGroup(list(nodes), stacked))
        elif isinstance(first, (list, nn.ModuleList)):
            if stacked or len(nodes) != 1:
                raise ValueError("leaf_groups: a stack inside a stack")
            walk(list(first), True)
        else:
            kids = [n.entries() if isinstance(n, Params) else n for n in nodes]
            for name in sorted(kids[0]):
                walk([k[name] for k in kids], stacked)

    walk([tree], False)
    return out


def _zeros(group: LeafGroup, shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=group.tensors[0].device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
    def init(params):
        groups = leaf_groups(params)
        return {"m": [_zeros(g, g.shape) for g in groups],
                "v": [_zeros(g, g.shape) for g in groups]}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = _f32(step) + 1.0
        bc1 = float(1.0 - _f32(b1) ** t)
        bc2 = float(1.0 - _f32(b2) ** t)
        for grp, ggrp, m, v in zip(leaf_groups(params), leaf_groups(grads), state["m"],
                                   state["v"]):
            decay = weight_decay and len(grp.shape) >= 2
            for i, (p, g) in enumerate(zip(grp.tensors, ggrp.tensors)):
                mi, vi = (m[i], v[i]) if grp.stacked else (m, v)
                g32 = g.float()
                mi.copy_(b1 * mi + (1 - b1) * g32)
                vi.copy_(b2 * vi + (1 - b2) * g32 * g32)
                u = (mi / bc1) / (torch.sqrt(vi / bc2) + eps)
                if decay:
                    u = u + weight_decay * p.float()
                p.copy_((p.float() - lr * u).to(p.dtype))
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment over the trailing two dims)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def adafactor(
    lr_fn,
    decay: float = 0.99,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    beta1: Optional[float] = None,   # None => no first moment (memory-lean)
    weight_decay: float = 0.0,
    # clip by the RMS of each slice of dim 0 of leaves of three or more dims
    # above this size (the reference lax.maps their update over dim 0)
    scan_update_threshold: Optional[int] = None,
):
    def init(params):
        v = []
        groups = leaf_groups(params)
        for g in groups:
            shape = g.shape
            if _factored(shape):
                v.append({"vr": _zeros(g, shape[:-1]),
                          "vc": _zeros(g, shape[:-2] + shape[-1:])})
            else:
                v.append({"v": _zeros(g, shape)})
        st = {"v": v}
        if beta1 is not None:
            st["m"] = [_zeros(g, g.shape) for g in groups]
        return st

    def stats(g32, vs, factored):
        """Update the second-moment statistics ``vs`` in place."""
        g2 = g32 * g32 + eps
        if factored:
            vs["vr"].copy_(decay * vs["vr"] + (1 - decay) * g2.mean(dim=-1))
            vs["vc"].copy_(decay * vs["vc"] + (1 - decay) * g2.mean(dim=-2))
        else:
            vs["v"].copy_(decay * vs["v"] + (1 - decay) * g2)

    def scaled(g32, vs, factored):
        """The unclipped update g / sqrt(v-hat)."""
        if factored:
            vr, vc = vs["vr"], vs["vc"]
            denom = torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps)
            vhat = (vr / denom)[..., None] * vc[..., None, :]
        else:
            vhat = vs["v"]
        return g32 * torch.rsqrt(vhat + eps)

    def apply(p, u, rms, m, decayed, lr):
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        if beta1 is not None:
            m.copy_(beta1 * m + (1 - beta1) * u)
            u = m
        if decayed:
            u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    def leaf_update(p, g, vs, m, lr, per_slice):
        """The reference's ``_leaf_update`` on one (stacked) leaf; with
        ``per_slice`` the RMS is taken over each slice of dim 0."""
        factored = _factored(p.shape)
        g32 = g.float()
        stats(g32, vs, factored)
        u = scaled(g32, vs, factored)
        dims = tuple(range(1, u.dim())) if per_slice else tuple(range(u.dim()))
        rms = torch.sqrt((u * u).mean(dim=dims, keepdim=per_slice) + eps)
        return apply(p, u, rms, m, weight_decay and p.dim() >= 2, lr)

    def layers_update(grp, ggrp, vs, m, lr, per_slice):
        """A stacked group of matrices, layer by layer through views of the
        stacked state: the same factored statistics (the stack's axis is not
        among the trailing two), the RMS summed over every layer first."""
        factored = _factored(grp.shape)
        n = math.prod(grp.shape)
        views = lambda i: {k: s[i] for k, s in vs.items()}   # noqa: E731
        sumsq = 0.0
        for i, g in enumerate(ggrp.tensors):
            stats(g.float(), views(i), factored)
            if not per_slice:
                u = scaled(g.float(), views(i), factored)
                sumsq = sumsq + (u * u).sum()
        rms = None if per_slice else torch.sqrt(sumsq / n + eps)
        for i, (p, g) in enumerate(zip(grp.tensors, ggrp.tensors)):
            u = scaled(g.float(), views(i), factored)
            r = torch.sqrt((u * u).mean() + eps) if per_slice else rms
            p.copy_(apply(p, u, r, None if m is None else m[i], bool(weight_decay), lr))

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        groups, g_groups = leaf_groups(params), leaf_groups(grads)
        m_list = state.get("m", [None] * len(groups))
        for grp, ggrp, vs, m in zip(groups, g_groups, state["v"], m_list):
            shape = grp.shape
            per_slice = (scan_update_threshold is not None and len(shape) >= 3
                         and shape[0] > 1 and math.prod(shape) > scan_update_threshold
                         and beta1 is None)
            if grp.stacked and grp.tensors[0].dim() >= 2:
                layers_update(grp, ggrp, vs, m, lr, per_slice)
            else:
                grp.assign(leaf_update(grp.value(), ggrp.value(), vs, m, lr, per_slice))
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    raise ValueError(name)
