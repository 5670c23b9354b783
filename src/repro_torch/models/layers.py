"""Shared building blocks of the LM slice: norms, positions, rotary
embeddings, attention, MLP, the pre-norm dense layer, and the parameter tree.

Mirrors the JAX package's ``models/layers.py``:

* attention weights keep the unflattened head layout: q/k/v (D, H, hd),
  out (H, hd, D);
* KV caches are (B, S_max, K, hd) per layer, indexed by position;
* weights are cast to the compute dtype at use (``.to`` is free for the
  matmul weights, which ``lm.to_compute_dtype_`` stores in it); norms,
  softmax and rotary run in float32.

Every attention without a cache goes through the flash-attention op (the
CUDA kernel on the card): self-attention in forward and prefill, the
encoder's bidirectional attention, and cross-attention in forward and
prefill.  Attention against a cache, the decode step's self- and
cross-attention, is plain torch (``_sdpa``), as the reference computes it
outside any kernel (``layers.py:137-169``).  The flash-attention op's
autograd ``_FlashAttention`` takes its gradient from ``_sdpa`` recomputed
from the saved inputs: the reference trains through ``_sdpa`` and has no
backward kernel.  The attention and MLP projections go through ``_proj``:
with ``cfg.grad_shard``, ``models/pmm.py``'s matmul (its gradient lands in
the weight's sharded layout), else one matmul over the contracted dims.
Not ported: ``_sdpa_q_chunked``, which no path without a cache reaches
here.

On DTensor operands (the dry-run's sharded cells, ``launch/dryrun.py``) the
kernel ops, which DTensor has no sharding strategy for, and ``_sdpa``
against a cache, whose grouped-head reshape DTensor cannot split where the
KV heads do not divide the mesh axis, run through ``local_kernel``:
``torch.distributed.tensor.experimental.local_map`` on each device's
shard, each operand redistributed first to a layout they can run locally
(sharded over batch rows and heads only).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig
from .pmm import _constrain
from .pmm import matmul as _pmm

__all__ = [
    "Params", "normal", "rms_norm", "layer_norm", "sinusoidal_pos", "rotary", "apply_rope",
    "KVCache", "init_attn", "attention", "init_mlp", "mlp", "init_dense_layer", "dense_layer",
    "pin_act", "local_kernel", "serving", "whole_dim", "replicated_where", "grad_like_forward",
    "fsdp_gathered",
]


class Params(nn.Module):
    """A tree of parameters built from nested dicts, with the reference's
    names: a tensor becomes an ``nn.Parameter`` (no gradient until the train
    step asks for one), a dict a ``Params`` and a list an ``nn.ModuleList``;
    a ``Params`` is kept as it is.  ``p["q"]`` reads as in the reference's
    param trees."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, (dict, Params)):
                self.add_module(name, _params(value))
            else:
                self.add_module(name, nn.ModuleList(_params(v) for v in value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def entries(self) -> dict:
        """Parameters and children by name: the tree's nodes one level down
        (a layer list is an ``nn.ModuleList``)."""
        out = dict(self.named_parameters(recurse=False))
        out.update(self.named_children())
        return out


def _params(value) -> Params:
    return value if isinstance(value, Params) else Params(value)


def normal(gen: torch.Generator, shape, cfg: ModelConfig, scale: float,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``scale * N(0, 1)`` of ``shape`` in ``dtype`` (default ``cfg.param_dtype``),
    drawn from ``gen`` on its device (the reference's
    ``jax.random.normal(k, shape, dtype) * s``), scaled in place."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype or cfg.param_dtype).mul_(scale)


def _whole(placements) -> list:
    return [Replicate() if p.is_partial() else p for p in placements]


class _Reduce(torch.autograd.Function):
    """A DTensor's pending sums reduced; its gradient, whole too, is passed
    back as it is (a masked partial sum, the vocab-sharded embedding's,
    takes no gradient redistributed back to its own kind)."""

    @staticmethod
    def forward(ctx, t):
        return t.redistribute(t.device_mesh, _whole(t.placements))

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, _whole(g.placements))


def replicated_where(t: torch.Tensor, drop) -> torch.Tensor:
    """A DTensor with each placement that ``drop(mesh_dim, placement)``
    picks, and each pending sum (``Partial``), replicated; a plain tensor
    as it is."""
    if not isinstance(t, DTensor):
        return t
    places = [Replicate() if p.is_partial() or drop(i, p) else p
              for i, p in enumerate(t.placements)]
    return t if places == list(t.placements) else t.redistribute(t.device_mesh, places)


def whole_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` gathered along ``dim`` once, before it is cut into pieces along
    ``dim``: DTensor gathers the whole tensor again for each piece cut from
    a sharded dim."""
    dim %= t.dim()
    return replicated_where(t, lambda i, p: isinstance(p, Shard) and p.dim == dim)


def _reduced(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with its pending sums (``Partial``) reduced, as a
    normalisation needs its input whole; a plain tensor as it is."""
    if isinstance(t, DTensor) and any(p.is_partial() for p in t.placements):
        return _Reduce.apply(t)
    return t


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = _reduced(x).float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = _reduced(x).float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def sinusoidal_pos(S: int, D: int, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """(S, D) sinusoidal positions: sin then cos of ``pos / 10000^(2i/D)``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def rotary(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for integer positions: (..., head_dim // 2) float32."""
    dim = torch.arange(head_dim // 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (2 * dim / head_dim))
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotary.  x (B, S, H, hd); cos/sin (S, hd//2) or (B, S, hd//2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S_max, K, hd), or stacked (L, B, S_max, K, hd)
    v: torch.Tensor


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = D ** -0.5
    p = {
        "q": normal(gen, (D, H, hd), cfg, s),
        "k": normal(gen, (D, K, hd), cfg, s),
        "v": normal(gen, (D, K, hd), cfg, s),
        "out": normal(gen, (H, hd, D), cfg, (H * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=cfg.param_dtype, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=cfg.param_dtype, device=gen.device)
    return p


def _sanitize_dw_spec(cfg: ModelConfig, w: torch.Tensor, dw_spec) -> tuple:
    """Drop spec axes whose mesh size doesn't divide the weight dim."""
    sizes = {"data": cfg.mesh_data_size, "model": cfg.mesh_model_size}
    out = []
    for dim, ax in zip(w.shape, dw_spec):
        sz = sizes.get(ax, 1) if isinstance(ax, str) else 1
        out.append(ax if (ax is not None and sz > 1 and dim % sz == 0) else None)
    return tuple(out)


def _mergeable(t: torch.Tensor, groups) -> torch.Tensor:
    """``t`` ready to have each group of ``groups`` consecutive dims merged
    by a reshape: a DTensor sharded on a dim inside a group (not its first)
    is replicated there, since DTensor's product of such a merge, a strided
    shard, has no matmul strategy."""
    inner, start = set(), 0
    for g in groups:
        inner.update(range(start + 1, start + g))
        start += g
    return replicated_where(t, lambda i, p: isinstance(p, Shard) and p.dim in inner)


def fsdp_gathered(w: torch.Tensor) -> torch.Tensor:
    """A (D, V) output weight with its D rows gathered (the FSDP gather,
    which ``pmm`` makes of the other weights) and its columns kept sharded,
    so that the product's output is sharded over the vocabulary."""
    return replicated_where(w, lambda i, p: isinstance(p, Shard) and p.dim == 0)


def _splittable(t: torch.Tensor, first: int) -> torch.Tensor:
    """``t`` ready to have its last dim split into dims the first of which is
    ``first`` long: a DTensor sharded on it over a mesh dim that does not
    divide ``first`` (heads that do not divide the model axis) is
    replicated there."""
    last = t.dim() - 1
    return replicated_where(t, lambda i, p: (isinstance(p, Shard) and p.dim == last
                                             and first % t.device_mesh.size(i)))


class _GradLikeForward(torch.autograd.Function):
    """The identity, whose backward gives a DTensor gradient the placements
    the forward value had (a pending sum reduced): for a value a reshape
    made, whose backward reshapes the gradient back."""

    @staticmethod
    def forward(ctx, t):
        ctx.placements = _whole(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


def grad_like_forward(t: torch.Tensor) -> torch.Tensor:
    """``t``; in the backward its DTensor gradient takes ``t``'s placements
    (``_GradLikeForward``).  A plain tensor, or one that needs no
    gradient, is returned as it is."""
    if isinstance(t, DTensor) and t.requires_grad:
        return _GradLikeForward.apply(t)
    return t


def _contract(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """x's trailing ``n`` dims against w's leading ``n``, as one matmul."""
    lead = x.shape[:x.dim() - n]
    k = w.shape[:n].numel()
    x = _mergeable(x, (len(lead), n))
    w = _mergeable(w.to(x.dtype), (n, w.dim() - n))
    out = _splittable(x.reshape(*lead, k) @ w.reshape(k, -1), w.shape[n])
    # the gradient, which the product's backward merges, in the output's layout
    return grad_like_forward(out.reshape(*lead, *w.shape[n:]))


def _proj(x: torch.Tensor, w: torch.Tensor, subscripts: str, cfg: ModelConfig,
          dw_spec) -> torch.Tensor:
    """Weight projection ``einsum(subscripts, x, w)`` in x's dtype: the
    ``pmm`` matmul with grad sharding when ``cfg.grad_shard``, else one
    matmul over the contracted dims (x's trailing, w's leading)."""
    if cfg.grad_shard:
        meta = (_sanitize_dw_spec(cfg, w, dw_spec), cfg.mesh_data_size, cfg.mesh_model_size,
                cfg.act_shard_spec or None)
        return _pmm(x, w.to(x.dtype), subscripts, meta)
    a, b = subscripts.split("->")[0].split(",")
    return _contract(x, w, len(set(a) & set(b)))


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: x (B, S, D) @ w (D, H, hd)."""
    return _contract(x, w, 1)


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention with float32 scores and softmax, the weights
    cast to v's dtype before the PV product (the reference's ``_sdpa``).

    q (B, Sq, H, hd); k, v (B, Skv, K, hd), the valid prefix of the cache;
    ``q_offset`` is the position of q[0] for the causal mask."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * hd ** -0.5
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Skv, device=q.device)
        logits = logits.masked_fill(~(qpos[:, None] >= kpos[None, :]), -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return o.reshape(B, Sq, H, hd)


def serving(fn):
    """Run ``fn`` (prefill, decode) under ``torch.inference_mode``, or under
    ``torch.no_grad`` when its params are DTensors, whose views cannot be
    made of inference tensors."""
    @functools.wraps(fn)
    def run(params, *args, **kwargs):
        sharded = isinstance(next(params.parameters()), DTensor)
        with torch.no_grad() if sharded else torch.inference_mode():
            return fn(params, *args, **kwargs)
    return run


def pin_act(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The residual stream pinned to the launcher's ``cfg.act_shard_spec``
    (the reference's ``with_sharding_constraint`` at each layer body): a
    DTensor is redistributed to it, a plain tensor is left as it is."""
    return _constrain(x, tuple(cfg.act_shard_spec)) if cfg.act_shard_spec else x


def _kernel_layout(args, roles, mesh):
    """Per operand, the placements ``local_kernel`` runs it with, and the
    mesh dim over which the GQA KV operands are sliced on each device (or
    None).  ``roles`` maps each operand's dims: ``"batch"`` and ``"head"``
    may be sharded (a kernel is local per batch row and per head);
    ``"group"`` follows the heads (shared where it has one group); ``"kv"``
    marks KV heads, which follow the query heads, or, where they do not
    divide the mesh dim but each device's query heads lie in one group,
    stay whole and are sliced to that group on each device.  Each mesh dim
    keeps the first operand's batch or head sharding where that works; the
    ``model`` mesh dim, which the sharding rules give the heads, shards the
    heads where the first operand is replicated over it and that works
    (each device then runs its share of the heads, a slice of what it
    holds); a mesh dim is replicated otherwise."""
    out = [[] for _ in args]
    lead = args[0].placements
    n_heads = args[0].shape[roles[0]["head"]] if "head" in roles[0] else 0
    kv_slice = None
    for i in range(mesh.ndim):
        n, p = mesh.size(i), lead[i]
        role = next((r for r, d in roles[0].items() if isinstance(p, Shard) and p.dim == d), None)
        if p.is_replicate() and n_heads and (mesh.mesh_dim_names or ())[i:i + 1] == ("model",):
            role = "head"
        place = [Replicate()] * len(args)
        sliced = False
        if role in ("batch", "head"):
            for j, (a, r) in enumerate(zip(args, roles)):
                d = r.get(role, r.get("group", r.get("kv")) if role == "head" else r.get("kv"))
                if d is None:
                    continue
                if a.shape[d] % n == 0:
                    place[j] = Shard(d)
                elif role == "head" and "group" in r and a.shape[d] == 1:
                    pass
                elif (role == "head" and "kv" in r and n % a.shape[d] == 0
                      and n_heads % n == 0 and kv_slice is None):
                    sliced = True
                else:
                    place = [Replicate()] * len(args)
                    sliced = False
                    break
        if sliced:
            kv_slice = i
        for j in range(len(args)):
            out[j].append(place[j])
    return [tuple(p) for p in out], kv_slice


def local_kernel(fn, args, roles, out_roles):
    """``fn(*args)`` on each device's shards when ``args[0]`` is a DTensor
    (``local_map``; plain operands are taken as replicated), else ``fn(*args)``.
    ``roles`` / ``out_roles``: per operand and output, its batch, head,
    group and KV-head dims (``_kernel_layout``).  KV operands sliced to a
    device's group get a partial-sum gradient over that mesh dim."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    args = [a if isinstance(a, DTensor) else
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for a in args]
    ins, kv_slice = _kernel_layout(args, roles, mesh)
    by_dim = {d: role for role, d in roles[0].items()}
    outs = []
    for r in out_roles:
        # an output is sharded as the first operand's dim of the same role is
        outs.append(tuple(Shard(r[by_dim[p.dim]]) if isinstance(p, Shard) else Replicate()
                          for p in ins[0]))
    grads = [list(p) for p in ins]
    run = fn
    if kv_slice is not None:
        # each device's query heads read one KV head: slice it here
        H, i = args[0].shape[roles[0]["head"]], kv_slice
        per_dev = H // mesh.size(i)
        kv = [j for j, r in enumerate(roles) if "kv" in r]
        for j in kv:
            grads[j][i] = Partial()

        def run(*local):
            local = list(local)
            rank = mesh.get_local_rank(i)
            for j in kv:
                d = roles[j]["kv"]
                g = H // args[j].shape[d]
                local[j] = local[j].narrow(d, rank * per_dev // g, 1)
            return fn(*local)
    return local_map(run, out_placements=tuple(outs), in_placements=tuple(ins),
                     in_grad_placements=tuple(tuple(g) for g in grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


_ATTN_ROLES = ({"batch": 0, "head": 2}, {"batch": 0, "kv": 2}, {"batch": 0, "kv": 2})
_ATTN_OUT_ROLES = ({"batch": 0, "head": 2},)


def _cached_sdpa(q, k, v, causal: bool, pos: int) -> torch.Tensor:
    """``_sdpa`` against a cache.  On DTensors, a cache sharded over its
    positions (``cache_specs``' flash-decoding layout) is attended to on
    DTensor's own strategies where it lies, each device over its
    positions, with the softmax's reductions across them; the query's
    heads are first replicated over a mesh dim the KV heads do not divide,
    whose grouped-head reshape DTensor cannot split.  Any other cache runs
    through ``local_kernel``, local per batch row and head."""
    if isinstance(q, DTensor) and not any(isinstance(p, Shard) and p.dim == 1
                                          for p in k.placements):
        # a cache sharded over its heads, not its positions: local per head
        return local_kernel(lambda q_, k_, v_: _sdpa(q_, k_, v_, causal=causal, q_offset=pos),
                            (q, k, v), _ATTN_ROLES, _ATTN_OUT_ROLES)
    K = k.shape[2]
    q = replicated_where(q, lambda i, p: (isinstance(p, Shard) and p.dim == 2
                                          and K % q.device_mesh.size(i)))
    return _sdpa(q, k, v, causal=causal, q_offset=pos)


class _FlashAttention(torch.autograd.Function):
    """The flash-attention op with the reference's training gradient.

    Forward runs the op (the CUDA kernel for CUDA tensors, which launches
    or raises; its plain version on the CPU) and saves only q, k and v.
    Backward recomputes ``_sdpa`` from them and returns its autograd
    gradient, which materialises the (B, K, G, Sq, Skv) float32 scores of
    one call: 134 MB at a microbatch of 2 x 512 positions and 32 heads."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, do):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            o = _sdpa(*inputs, causal=ctx.causal)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(o, wanted, do))
        return (*(next(grads) if n else None for n in needs), None)


def attention(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
              cache: Optional[KVCache] = None, pos: Optional[int] = None,
              kv_x: Optional[torch.Tensor] = None, use_rope: bool = True,
              precomputed_kv: Optional[KVCache] = None, collect_kv: bool = False):
    """Self- or cross-attention for forward, prefill and decode.  Returns
    (out, cache).

    * Self-attention (neither ``kv_x`` nor ``precomputed_kv``) projects K/V
      from ``x`` and applies rope when ``use_rope``.  Without a cache
      (forward, prefill) it runs the flash-attention op and, with
      ``collect_kv``, returns the fresh post-rope K/V as the cache.  With a
      cache (decode) it writes the new K/V into ``cache`` in place at ``pos``
      and attends to the prefix ``[0, pos + S)``: the same result as the
      reference's attention over the padded cache with its ``kv_len`` mask,
      whose masked keys weigh exactly 0.
    * Cross-attention projects K/V from ``kv_x`` (forward), or reads them
      from ``precomputed_kv`` (prefill and decode: the encoder's K/V held in
      the cache); neither applies rope, and precomputed K/V take no k-norm.
      Precomputed K/V at a decode step (``pos`` given) are attended to with
      the plain ``_sdpa``, as any cache is; otherwise through the flash op.

    The flash op's causal mask is top-left aligned, so a causal call needs
    as many keys as queries."""
    B, S, D = x.shape
    q = _proj(x, p["q"], "bsd,dhk->bshk", cfg, ("data", "model", None))
    if precomputed_kv is not None:
        k, v = precomputed_kv
    else:
        src = x if kv_x is None else kv_x
        kv_spec = ("data", None, None)
        k = _proj(src, p["k"], "bsd,dhk->bshk", cfg, kv_spec)
        v = _proj(src, p["v"], "bsd,dhk->bshk", cfg, kv_spec)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if precomputed_kv is None:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and precomputed_kv is None and kv_x is None:
        offset = 0 if pos is None else pos
        cos, sin = rotary(torch.arange(S, device=x.device) + offset, cfg.head_dim,
                          cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is not None:
        cache.k[:, pos:pos + S] = k
        cache.v[:, pos:pos + S] = v
        o = _cached_sdpa(q, cache.k[:, :pos + S], cache.v[:, :pos + S], causal, pos)
        new_cache = cache
    elif precomputed_kv is not None and pos is not None:
        o = local_kernel(lambda q_, k_, v_: _sdpa(q_, k_, v_, causal=causal), (q, k, v),
                         _ATTN_ROLES, _ATTN_OUT_ROLES)
    else:
        if causal and k.shape[1] != S:
            raise ValueError(f"attention: a causal call needs as many keys as queries, "
                             f"got {k.shape[1]} keys for {S} queries")
        o = local_kernel(lambda q_, k_, v_: _FlashAttention.apply(q_, k_, v_, causal),
                         (q, k, v), _ATTN_ROLES, _ATTN_OUT_ROLES)
        if collect_kv:
            new_cache = KVCache(k, v)
    out = _proj(o, p["out"], "bshk,hkd->bsd", cfg, ("model", None, "data"))
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    s_in, s_out = D ** -0.5, Fd ** -0.5
    p = {"up": normal(gen, (D, Fd), cfg, s_in), "down": normal(gen, (Fd, D), cfg, s_out)}
    if cfg.glu:
        p["gate"] = normal(gen, (D, Fd), cfg, s_in)
    return p


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if name == "silu" else F.gelu(x, approximate="tanh")


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = _proj(x, p["up"], "bsd,df->bsf", cfg, ("data", "model"))
    if cfg.glu:
        h = _act(_proj(x, p["gate"], "bsd,df->bsf", cfg, ("data", "model")), cfg.act) * up
    else:
        h = _act(up, cfg.act)
    return _proj(h, p["down"], "bsf,fd->bsd", cfg, ("model", "data"))


# ---------------------------------------------------------------------------
# a full pre-norm dense transformer layer
# ---------------------------------------------------------------------------


def init_dense_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device)
    return {"ln1": zeros(), "attn": init_attn(gen, cfg), "ln2": zeros(),
            "mlp": init_mlp(gen, cfg)}


def dense_layer(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
                cache: Optional[KVCache] = None, pos: Optional[int] = None,
                collect_kv: bool = False):
    h, new_cache = attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                             causal=causal, cache=cache, pos=pos, collect_kv=collect_kv)
    x = x + h
    x = x + mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x, new_cache
