"""Mixture-of-Experts block with capacity-bounded sort-based dispatch, after
the JAX package's ``models/moe.py``.

Tokens are routed top-k, ranked per expert by router weight, and the top
``capacity`` tokens of each expert are gathered into a dense (E, C, D)
buffer; the expert products are ``torch.bmm`` over it, as the reference
computes them with einsums outside any kernel.  Compute is ``cf·T·k·D·F``.

Nothing here waits for the host: no ``nonzero``, no boolean-mask indexing,
no tensor-sized repeat, no ``.item()``; every shape follows from ``T``,
``k``, ``E`` and the capacity.  Two differences from the reference's
arithmetic, neither of which changes a routing decision:

* dropped assignments are written to a spare column ``C`` of an
  (E, C + 1) slot table that is cut off afterwards, where the reference
  scatters them out of bounds with ``mode="drop"``;
* the combine gathers each token's ``k`` weighted expert outputs (a dropped
  assignment reads a zero row) and adds them in the order of the router's
  top-k, strongest first, each add rounded to the compute dtype.  The
  reference scatter-adds them in the compute dtype in an order its
  compiler picks; a scatter-add on the card (``index_add_``) adds with
  atomics, so its bf16 sums would differ from run to run.  The gather keeps
  runs repeatable.

The expert products go through ``_emm``: ``pmm``'s matmul with grad
sharding when ``cfg.grad_shard`` and ``cfg.moe_ep_shard`` are set.  With
``cfg.moe_ep_shard`` (set by the dry-run's launcher) ``_ep`` pins the
dispatch buffers ``xe``, the gated ``h`` and ``ye`` to expert parallelism,
experts over ``model``, as the reference's ``_ep`` does: a redistribution
of DTensors, no op on plain tensors.

``moe_block_dense`` is the one-hot oracle of the tests (the same math when
nothing is dropped).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from .config import ModelConfig
from .layers import (
    _act, _mergeable, _sanitize_dw_spec, _whole, grad_like_forward, local_kernel, normal,
    replicated_where,
)
from .pmm import _constrain
from .pmm import matmul as _pmm

__all__ = ["init_moe", "moe_block", "moe_block_dense", "route_topk", "MOE_CHUNK_TOKENS"]

# dispatch chunk bound: routing and capacity are computed per chunk of this
# many tokens (the reference's block-wise MoE); read at each call
MOE_CHUNK_TOKENS = 65536


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The reference's MoE params: ``router`` and ``shared_gate`` in float32
    whatever ``cfg.param_dtype`` is (``moe.py:31, :43``)."""
    D, Fe, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s_in, s_out = D ** -0.5, Fe ** -0.5
    p = {
        "router": normal(gen, (D, E), cfg, s_in, torch.float32),
        "e_gate": normal(gen, (E, D, Fe), cfg, s_in),
        "e_up": normal(gen, (E, D, Fe), cfg, s_in),
        "e_down": normal(gen, (E, Fe, D), cfg, s_out),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * cfg.d_ff
        p["shared"] = {
            "gate": normal(gen, (D, Fs), cfg, s_in),
            "up": normal(gen, (D, Fs), cfg, s_in),
            "down": normal(gen, (Fs, D), cfg, Fs ** -0.5),
            "shared_gate": normal(gen, (D, 1), cfg, s_in, torch.float32),
        }
    return p


def route_topk(router_logits: torch.Tensor, k: int):
    """Top-k routing with renormalised softmax weights.  router_logits (T, E)
    -> (expert_idx (T, k) int64, weights (T, k) float32), strongest first.
    Exact ties may be ordered otherwise than by ``lax.top_k``."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return idx, w


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    c = int(max(1, round(cf * T * k / E)))       # Python's round: half to even
    return min(max(c, 4), T)


def _shared_experts(sp, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Qwen2-MoE's sigmoid-gated shared experts, gate in float32."""
    g = _act(xt @ sp["gate"].to(xt.dtype), cfg.act)
    ys = (g * (xt @ sp["up"].to(xt.dtype))) @ sp["down"].to(xt.dtype)
    sgate = torch.sigmoid(xt.float() @ sp["shared_gate"].float())
    return ys * sgate.to(ys.dtype)


def moe_block(p, x: torch.Tensor, cfg: ModelConfig,
              capacity: Optional[int] = None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D).  Above ``MOE_CHUNK_TOKENS`` tokens (when they
    divide B * S) the tokens go in chunks, each routed with its own capacity."""
    B, S, D = x.shape
    chunk = MOE_CHUNK_TOKENS
    if B * S > chunk and (B * S) % chunk == 0:
        # over DTensors the tokens are replicated first: DTensor cannot cut
        # a batch- or sequence-sharded token axis into chunks
        xc = _replicated(x).reshape((B * S) // chunk, 1, chunk, D)
        return grad_like_forward(
            torch.cat([_moe_block_inner(p, c, cfg, capacity) for c in xc]).reshape(B, S, D))
    return _moe_block_inner(p, x, cfg, capacity)


def dispatch(router_logits: torch.Tensor, k: int, C: int):
    """Sort-based capacity dispatch of (T, E) router logits into C slots per
    expert.  Returns ``(idx, w, slot_tok, slot_w, slot_of)``: the top-k
    experts and weights (T, k); the token of each (expert, slot), T where the
    slot is empty, and its weight (E, C); and the flat slot ``e * C + c`` of
    each (token, rank), ``E * C`` where the assignment was dropped (T, k)."""
    T, E = router_logits.shape
    dev = router_logits.device
    idx, w = route_topk(router_logits, k)
    flat_e, flat_w = idx.reshape(-1), w.reshape(-1)
    n = T * k
    flat_tok = torch.arange(n, device=dev) // k
    # sort by (expert, -weight) with two stable passes: the strongest tokens
    # of each expert keep their slots
    order1 = torch.argsort(-flat_w, stable=True)
    order = order1[torch.argsort(flat_e[order1], stable=True)]
    se, sw, st = flat_e[order], flat_w[order], flat_tok[order]
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos_in_e = torch.arange(n, device=dev) - starts[se]
    keep = pos_in_e < C
    # dropped assignments land in the spare column C, cut off below
    cell = se * (C + 1) + torch.where(keep, pos_in_e, C)
    slot_tok = torch.full((E * (C + 1),), T, dtype=torch.int64, device=dev)
    slot_tok.scatter_(0, cell, st)
    slot_w = torch.zeros(E * (C + 1), dtype=torch.float32, device=dev)
    slot_w.scatter_(0, cell, sw)
    slot_of = torch.empty(n, dtype=torch.int64, device=dev)
    slot_of.scatter_(0, order, torch.where(keep, se * C + pos_in_e, E * C))
    return (idx, w, slot_tok.reshape(E, C + 1)[:, :C], slot_w.reshape(E, C + 1)[:, :C],
            slot_of.reshape(T, k))


def _emm(a: torch.Tensor, w: torch.Tensor, subs: str, dw_spec, cfg: ModelConfig):
    """An expert product (E, C, ·) x (E, ·, ·): ``torch.bmm``, or the ``pmm``
    matmul when ``cfg.grad_shard`` and ``cfg.moe_ep_shard`` are set
    (``moe.py:132-137``)."""
    if cfg.grad_shard and cfg.moe_ep_shard:
        meta = (_sanitize_dw_spec(cfg, w, dw_spec), cfg.mesh_data_size, cfg.mesh_model_size,
                None)
        return _pmm(a, w.to(a.dtype), subs, meta)
    return torch.bmm(a, w.to(a.dtype))


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """``t`` replicated on every mesh dim (over DTensors)."""
    return replicated_where(t, lambda i, p: True)


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t``'s rows at ``idx`` (flattened).  Over DTensors each device
    gathers from the whole replicated ``t`` (``index_select``'s backward,
    ``index_add``, has no DTensor strategy)."""
    return local_kernel(lambda a, i: a.index_select(0, i.reshape(-1)), (t, idx), [{}, {}], [{}])


def _ep(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Experts over ``model`` (the reference's ``_ep``, ``moe.py:120-126``)."""
    if not cfg.moe_ep_shard:
        return t
    return _constrain(t, ("model",) + (None,) * (t.dim() - 1))


def _moe_block_inner(p, x: torch.Tensor, cfg: ModelConfig,
                     capacity: Optional[int] = None) -> torch.Tensor:
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.moe_top_k
    # a sequence-sharded residual (Megatron-SP) is gathered over the
    # sequence first: DTensor cannot fold it into the token axis
    xt = grad_like_forward(_mergeable(x, (2, 1)).reshape(T, D))
    router_logits = xt.float() @ p["router"].float()                  # (T, E) float32
    C = _capacity(T, k, E, cfg.capacity_factor) if capacity is None else capacity
    # the sort-based dispatch has no DTensor strategy: over DTensors every
    # device computes the global slot tables from the replicated logits
    _, _, slot_tok, slot_w, slot_of = local_kernel(lambda r: dispatch(r, k, C),
                                                   (router_logits,), [{}], [{}] * 5)

    # gather each expert's tokens; an empty slot reads the zero row T
    xt_pad = torch.cat([xt, xt.new_zeros(1, D)])
    xe = _ep(grad_like_forward(_rows(xt_pad, slot_tok).reshape(E, C, D)), cfg)
    gate = _emm(xe, p["e_gate"], "ecd,edf->ecf", ("model", "data", None), cfg)
    up = _emm(xe, p["e_up"], "ecd,edf->ecf", ("model", "data", None), cfg)
    h = _ep(_act(gate, cfg.act) * up, cfg)
    ye = _ep(_emm(h, p["e_down"], "ecf,efd->ecd", ("model", None, "data"), cfg),
             cfg)                                                          # (E, C, D)

    # combine: gather each token's k weighted outputs, add strongest first
    # over DTensors the combine reads the replicated expert outputs (as
    # ``_rows`` would gather them), so they are replicated before they are
    # flattened: an expert axis that does not divide the mesh cannot be
    yw = (_replicated(ye) * slot_w[..., None].to(ye.dtype)).reshape(E * C, D)
    yw = torch.cat([yw, yw.new_zeros(1, D)])
    parts = _rows(yw, slot_of).reshape(T, k, D)
    yt = parts[:, 0]
    for j in range(1, k):
        yt = yt + parts[:, j]
    if cfg.n_shared_experts:
        yt = yt + _shared_experts(p["shared"], xt, cfg)
    if isinstance(yt, DTensor):
        # back to the tokens' layout, which the reshape to (B, S) can split
        yt = yt.redistribute(yt.device_mesh, _whole(xt.placements))
    return grad_like_forward(yt.reshape(B, S, D))


def moe_block_dense(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One-hot dense oracle: every expert on every token, combined by the
    top-k weights; no token is dropped."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    idx, w = route_topk(xt.float() @ p["router"].float(), cfg.moe_top_k)
    comb = torch.zeros((T, cfg.n_experts), dtype=torch.float32, device=x.device)
    comb.scatter_add_(1, idx, w)                                        # (T, E)
    gate = torch.einsum("td,edf->tef", xt, p["e_gate"].to(xt.dtype))
    up = torch.einsum("td,edf->tef", xt, p["e_up"].to(xt.dtype))
    ye = torch.einsum("tef,efd->ted", _act(gate, cfg.act) * up, p["e_down"].to(xt.dtype))
    yt = torch.einsum("ted,te->td", ye, comb.to(ye.dtype))
    if cfg.n_shared_experts:
        yt = yt + _shared_experts(p["shared"], xt, cfg)
    return yt.reshape(B, S, D)
