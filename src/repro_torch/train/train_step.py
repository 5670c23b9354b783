"""Train and serve step builders, after the JAX package's
``train/train_step.py``.

``make_train_step`` builds ``(state, batch) -> (state, metrics)`` with
microbatched gradient accumulation: each microbatch's forward and backward
run in turn, so live activation memory scales with the microbatch
(DESIGN.md §6).  The loss is masked token cross-entropy in float32 with an
optional z-loss; gradients accumulate in the parameter dtype.  Every family
goes through its model's ``forward``, encdec included (``:47-48``); the
forward's flash-attention and SSD ops run their CUDA kernels on a card and
take the reference's training gradient (``_sdpa``, ``_ssd_chunked``) in the
backward.

The step updates the params and the optimizer state in place and returns
the state with the next step.  It runs on its params' device.  With
``batch_axes`` (the launcher's ``(mesh axis, size)`` pairs of the batch
rule) each microbatch leaf is pinned to the longest prefix of those axes
whose size divides its rows, as the reference's ``_pin_batch`` does: a
redistribution of DTensor batches, no op on plain tensors.

``make_serve_step`` wraps prefill and decode for the serving shapes.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import make_generator, resolve_device
from ..models import encdec, lm
from ..models.config import ModelConfig
from ..models.layers import grad_like_forward
from ..models.pmm import _constrain
from .optimizer import Optimizer

__all__ = ["TrainState", "make_train_step", "make_serve_step", "init_train_state", "xent_loss"]


class TrainState(NamedTuple):
    step: torch.Tensor       # 0-d int32, on the host
    params: Any              # a ``Params`` tree
    opt_state: Any


def xent_loss(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4) -> torch.Tensor:
    """Masked softmax cross-entropy (float32).  labels < 0 are ignored.
    Over DTensors the labels take the logits' layout of their positions."""
    logits = logits.float()
    if isinstance(logits, DTensor) and isinstance(labels, DTensor):
        labels = labels.redistribute(logits.device_mesh, [
            p if isinstance(p, Shard) and p.dim < labels.dim() else Replicate()
            for p in logits.placements])
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    lse, gold = _lse_gold(logits, safe)
    nll = (lse - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    if z_loss:
        loss = loss + z_loss * ((lse * mask) ** 2).sum() / denom
    return loss


def _lse_gold(logits: torch.Tensor, safe: torch.Tensor):
    """Each position's log-sum-exp and gold logit.  Over DTensor logits,
    whose vocabulary may be sharded, both are sums over each device's
    vocabulary slice, reduced afterwards (vocabulary-parallel): the gold
    logit is picked by comparing the labels with the sharded vocabulary
    ids, where a gather's gradient is a whole-vocabulary scatter."""
    if not isinstance(logits, DTensor):
        return (torch.logsumexp(logits, dim=-1),
                torch.gather(logits, -1, safe[..., None])[..., 0])
    mesh, last = logits.device_mesh, logits.dim() - 1
    # the logits' gradient in their own layout (vocabulary-sharded), where
    # DTensor's choice would shard it over the sequence
    logits = grad_like_forward(logits)
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)))[..., 0]
    ids = DTensor.from_local(torch.arange(logits.shape[-1], device=logits.device), mesh,
                             [Replicate()] * mesh.ndim, run_check=False)
    ids = ids.redistribute(mesh, [Shard(0) if isinstance(p, Shard) and p.dim == last
                                  else Replicate() for p in logits.placements])
    gold = torch.where(safe[..., None] == ids, logits, 0.0).sum(dim=-1)
    return lse, gold


def _model(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else lm


def init_train_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                     optimizer: Optimizer) -> TrainState:
    """Params drawn from ``generator`` on its device (None: seed 0 on the
    card) in ``cfg.param_dtype``, the optimizer's state, step 0."""
    if generator is None:
        generator = make_generator(0, resolve_device(None))
    params = _model(cfg).init_params(generator, cfg, for_training=True)
    return TrainState(torch.zeros((), dtype=torch.int32), params, optimizer.init(params))


def _grads(node):
    """The gradients of a ``Params`` tree as nested dicts and lists of the
    same structure (zeros for a parameter the loss does not reach, as
    ``jax.grad`` gives)."""
    if isinstance(node, nn.Parameter):
        return node.grad if node.grad is not None else torch.zeros_like(node)
    if isinstance(node, nn.ModuleList):
        return [_grads(c) for c in node]
    return {name: _grads(c) for name, c in node.entries().items()}


def _pin_batch(mb: Dict[str, torch.Tensor], batch_axes) -> Dict[str, torch.Tensor]:
    """Each leaf's rows over the longest prefix of ``batch_axes`` whose size
    divides them (the reference's ``_pin_batch``, ``train_step.py:81-106``)."""
    if not batch_axes:
        return mb
    out = {}
    for key, a in mb.items():
        names, prod = [], 1
        for name, size in batch_axes:
            if a.shape[0] % (prod * size):
                break
            names.append(name)
            prod *= size
        if names:
            entry = names[0] if len(names) == 1 else tuple(names)
            a = _constrain(a, (entry,) + (None,) * (a.dim() - 1))
        out[key] = a
    return out


def _sync_grads(leaves) -> None:
    """Each DTensor gradient in its parameter's placements, once a step: the
    data-parallel reduction (a reduce-scatter where the parameter is
    sharded) that the norm and the optimizer would otherwise each force on
    a pending sum.  Plain gradients are left as they are."""
    with torch.no_grad():
        for p in leaves:
            g = p.grad
            if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
                p.grad = g.redistribute(p.device_mesh, p.placements)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, accum_steps: int = 1,
                    label_key: str = "labels", batch_axes: Optional[tuple] = None):
    forward = _model(cfg).forward

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        leaves = [p for p in params.parameters() if p.is_floating_point()]
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if accum_steps == 1:
            mbs = [batch]
        else:
            # (GB, ...) -> accum microbatches of GB / accum rows, in order
            sizes = {a.shape[0] for a in batch.values()}
            if len(sizes) != 1 or next(iter(sizes)) % accum_steps:
                raise ValueError(f"batch rows {sorted(sizes)} do not split into "
                                 f"{accum_steps} microbatches")
            mbs = [dict(zip(batch, parts)) for parts in
                   zip(*(a.chunk(accum_steps) for a in batch.values()))]
        lsum = None
        for mb in mbs:
            mb = _pin_batch(mb, batch_axes)
            loss = xent_loss(forward(params, mb, cfg), mb[label_key])
            loss.backward()
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        _sync_grads(leaves)
        grads = _grads(params)
        if accum_steps > 1:
            scale = 1.0 / accum_steps
            for p in leaves:
                if p.grad is not None:
                    p.grad.mul_(torch.tensor(scale, dtype=p.grad.dtype))
            lsum = lsum * scale
        with torch.no_grad():
            gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in leaves
                                   if p.grad is not None))
        optimizer.update(grads, state.opt_state, params, state.step)
        for p in leaves:
            p.grad = None
        metrics = {"loss": lsum, "grad_norm": gnorm, "step": state.step}
        return TrainState(state.step + 1, params, state.opt_state), metrics

    return train_step


def make_serve_step(cfg: ModelConfig, kind: str, max_len: Optional[int] = None):
    """kind = 'prefill' | 'decode'.

    prefill: (params, batch, cache=None) -> (logits, cache); ``cache``: zero
             caches to fill (the dry-run passes them sharded)
    decode : (params, cache, token, pos) -> (logits, cache)
    """
    mod = _model(cfg)
    if kind == "prefill":
        if cfg.family == "encdec":
            def prefill_step(params, batch, cache=None):
                return encdec.prefill(params, batch, cfg, self_kv=cache)
        else:
            def prefill_step(params, batch, cache=None):
                return lm.prefill(params, batch, cfg, max_len=max_len, cache=cache)
        return prefill_step
    if kind == "decode":
        def decode_step(params, cache, token, pos):
            return mod.decode(params, cache, token, pos, cfg)
        return decode_step
    raise ValueError(kind)
