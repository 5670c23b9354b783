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
the state with the next step.  It runs on its params' device.  The
reference's ``batch_axes`` and ``_pin_batch`` (GSPMD constraints on the
microbatch's sharding) have no meaning on one card and are not ported.

``make_serve_step`` wraps prefill and decode for the serving shapes.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from ..device import make_generator, resolve_device
from ..models import encdec, lm
from ..models.config import ModelConfig
from .optimizer import Optimizer

__all__ = ["TrainState", "make_train_step", "make_serve_step", "init_train_state", "xent_loss"]


class TrainState(NamedTuple):
    step: torch.Tensor       # 0-d int32, on the host
    params: Any              # a ``Params`` tree
    opt_state: Any


def xent_loss(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4) -> torch.Tensor:
    """Masked softmax cross-entropy (float32).  labels < 0 are ignored."""
    logits = logits.float()
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom
    if z_loss:
        loss = loss + z_loss * ((lse * mask) ** 2).sum() / denom
    return loss


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


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, accum_steps: int = 1,
                    label_key: str = "labels"):
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
            loss = xent_loss(forward(params, mb, cfg), mb[label_key])
            loss.backward()
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
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

    prefill: (params, batch) -> (logits, cache)
    decode : (params, cache, token, pos) -> (logits, cache)
    """
    mod = _model(cfg)
    if kind == "prefill":
        if cfg.family == "encdec":
            def prefill_step(params, batch):
                return encdec.prefill(params, batch, cfg)
        else:
            def prefill_step(params, batch):
                return lm.prefill(params, batch, cfg, max_len=max_len)
        return prefill_step
    if kind == "decode":
        def decode_step(params, cache, token, pos):
            return mod.decode(params, cache, token, pos, cfg)
        return decode_step
    raise ValueError(kind)
