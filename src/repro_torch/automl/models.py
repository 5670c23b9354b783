"""Model families of the AutoML substrate in PyTorch (DESIGN.md §5.4, §10.1).

The port of the JAX package's ``automl/models.py``.  Each family implements
init / loss / predict (or a closed-form fit) on dense ``(N, d)`` float32
features and int64 labels; params are dicts of tensors (``{"w", "b"}``,
``{"layers": [{"w", "b"}, ...]}``, ...), the same trees as the reference.
Gradients come from ``torch.autograd`` in place of ``jax.grad``.

Every family function also takes a stack of ``T`` trials: params, features
and labels with a leading trial axis (``(T, N, d)``, ``(T, N)``), a per-trial
HP as a ``(T,)`` tensor, a loss or accuracy per trial as ``(T,)``.  Matmuls
broadcast to batched products (``torch.bmm``; trial by trial above
``STACKED_MATMUL_MAX_ROWS`` rows), so the loop backend
(``engine._eval_rung_loop``, one trial) and the batched cohort backend
(``batched.py``, a sub-batch) run the same definitions, as the reference's
``jax.vmap`` runs the same functions in both.

``ModelFamily.shape_hps`` names the HPs that change the param shapes (MLP
``depth`` and ``width``): the batched backend sub-batches on those.
``init_keyless`` marks the zero-init families, whose cohort init is one
broadcast.

Training is full-batch Adam (``adam_train``), a Python loop over steps whose
tensors stay on the device; on a card, a call of ``ADAM_GRAPH_MIN_STEPS`` or
more steps replays its steps from a CUDA graph of one step.  Float32 matmuls
run in full float32: the port turns TF32 off when it resolves a CUDA device
(``device.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import capture_resources
from ..obs import trace as _trace

__all__ = ["FAMILIES", "ModelFamily", "adam_train", "train_model",
           "predict_model", "accuracy", "masked_loss", "masked_fit",
           "masked_accuracy", "CLASS_MASK_NEG"]


class ModelFamily(NamedTuple):
    name: str
    init: Optional[Callable[..., Any]]
    loss: Optional[Callable[..., torch.Tensor]]   # None => closed-form fit
    fit_closed: Optional[Callable[..., Any]]
    predict: Callable[..., torch.Tensor]
    hp_grid: Dict[str, tuple]
    # HPs that change param shapes or tree structure; the batched engine
    # sub-batches on these (DESIGN.md §10.3)
    shape_hps: tuple = ()
    # init ignores the generator (zero init): the batched engine broadcasts
    # one init across the sub-batch
    init_keyless: bool = False


def _per_trial(v, ndim: int):
    """A per-trial HP shaped to broadcast against a tensor of ``ndim`` dims
    with a leading trial axis: a ``(T,)`` tensor becomes ``(T, 1, ..., 1)``;
    a Python float stays as it is."""
    if isinstance(v, torch.Tensor) and v.ndim:
        return v.view((-1,) + (1,) * (ndim - 1))
    return v


# Above this many rows a stack of trials multiplies trial by trial: the
# weight gradient of a product is a reduction over the rows, and cuBLAS
# splits that long K for a 2-D product but not for a strided-batched one
# (2.7 ms per 128 x 128 weight gradient at 83k rows on an H100).  Below it
# the stack is bound by launches, and one batched product wins.
STACKED_MATMUL_MAX_ROWS = 2048

# From this many steps on, ``adam_train`` on a card replays its steps from a
# CUDA graph of one step; below it, the eager loop.  Capturing costs about
# one eager step of host time on top of the eager first step: on an H100,
# a whole 2-step call took 0.5-1.1 ms longer through the graph (7.08 against
# 5.98 ms for two MLP trials over 11,145 rows) and a 3-step call 0.6-1.8 ms
# less (7.51 against 8.83 ms), at each of the benchmark's trial shapes.
ADAM_GRAPH_MIN_STEPS = 3


def _matmul(X, w):
    """``X @ w``; a stack of trials with more than
    ``STACKED_MATMUL_MAX_ROWS`` rows takes one 2-D product per trial."""
    if X.ndim == 3 and X.shape[-2] > STACKED_MATMUL_MAX_ROWS:
        if X.shape[0] == 1:
            return (X[0] @ w[0]).unsqueeze(0)
        return torch.stack([x @ v for x, v in zip(X, w)])
    return X @ w


def _one_hot(y, c):
    """``(..., N)`` labels -> ``(..., N, c)`` float32 one-hot (a compare with
    ``arange``: no check of the labels' range, so no host sync on a card)."""
    return (y.unsqueeze(-1) == torch.arange(c, device=y.device)).to(torch.float32)


# ---------------------------------------------------------------------------
# gradient-trained families
# ---------------------------------------------------------------------------


def _nll(logits, y):
    return -F.log_softmax(logits, dim=-1).gather(-1, y.unsqueeze(-1)).squeeze(-1)


def _xent(logits, y):
    return _nll(logits, y).mean(-1)


def _sq_sum(w):
    return (w ** 2).sum((-2, -1))


def _logreg_init(gen, d, c, hp, device):
    return {"w": torch.zeros((d, c), device=device), "b": torch.zeros((c,), device=device)}


def _logreg_loss(params, X, y, c, hp):
    return _xent(_logreg_predict(params, X), y) + hp["l2"] * _sq_sum(params["w"])


def _logreg_predict(params, X):
    return _matmul(X, params["w"]) + params["b"].unsqueeze(-2)


def _mlp_init(gen, d, c, hp, device):
    width, depth = int(hp["width"]), int(hp["depth"])
    dims = [d] + [width] * depth + [c]
    layers = []
    for i in range(len(dims) - 1):
        scale = (2.0 / dims[i]) ** 0.5
        w = torch.randn((dims[i], dims[i + 1]), generator=gen, device=gen.device) * scale
        layers.append({"w": w.to(device), "b": torch.zeros((dims[i + 1],), device=device)})
    return {"layers": layers}


def _mlp_forward(params, X):
    h = X
    layers = params["layers"]
    for i, lyr in enumerate(layers):
        h = _matmul(h, lyr["w"]) + lyr["b"].unsqueeze(-2)
        if i < len(layers) - 1:
            # ReLU keeps width padding inert: a padded unit is 0 and
            # relu'(0) = 0, so it gets no gradient (DESIGN.md §10.4)
            h = torch.relu(h)
    return h


def _mlp_reg(params):
    return sum(_sq_sum(lyr["w"]) for lyr in params["layers"])


def _mlp_loss(params, X, y, c, hp):
    return _xent(_mlp_forward(params, X), y) + hp["l2"] * _mlp_reg(params)


def _hinge(logits, y):
    """Multi-class hinge margins; the true class's margin is zeroed and kept
    out of the gradient, as the reference's ``margins.at[arange, y].set(0.0)``
    does: a mask, not an in-place write on a tensor autograd needs."""
    margins = (logits - logits.gather(-1, y.unsqueeze(-1)) + 1.0).clamp_min(0.0)
    own = y.unsqueeze(-1) == torch.arange(logits.shape[-1], device=y.device)
    return torch.where(own, 0.0, margins).sum(-1)


def _svm_loss(params, X, y, c, hp):
    return (_hinge(_logreg_predict(params, X), y).mean(-1)
            + hp["l2"] * _sq_sum(params["w"]))


# ---------------------------------------------------------------------------
# closed-form families
# ---------------------------------------------------------------------------


def _gnb_stats(onehot, X, n_rows, eps):
    cnt = onehot.sum(-2).unsqueeze(-1)                       # (..., c, 1)
    mean = (onehot.mT @ X) / cnt.clamp_min(1.0)              # (..., c, d)
    sq = (onehot.mT @ (X ** 2)) / cnt.clamp_min(1.0)
    var = (sq - mean ** 2).clamp_min(0.0) + _per_trial(eps, X.ndim)
    prior = torch.log((cnt[..., 0] / n_rows).clamp_min(1e-12))
    return {"mean": mean, "var": var, "prior": prior}


def _gnb_fit(gen, X, y, c, hp):
    return _gnb_stats(_one_hot(y, c), X, X.shape[-2], hp["var_smoothing"])


def _gnb_predict(params, X):
    # log N(x | mu, var) summed over dims + log prior
    mu, var, prior = params["mean"], params["var"], params["prior"]
    ll = -0.5 * (((X.unsqueeze(-2) - mu.unsqueeze(-3)) ** 2) / var.unsqueeze(-3)
                 + torch.log(2 * torch.pi * var).unsqueeze(-3)).sum(-1)
    return ll + prior.unsqueeze(-2)


def _shrunk(cent, overall, shrinkage):
    return overall + (cent - overall) * (1.0 - _per_trial(shrinkage, cent.ndim))


def _centroid_fit(gen, X, y, c, hp):
    onehot = _one_hot(y, c)
    cnt = onehot.sum(-2).unsqueeze(-1)
    cent = (onehot.mT @ X) / cnt.clamp_min(1.0)
    return {"cent": _shrunk(cent, X.mean(-2, keepdim=True), hp["shrinkage"])}


def _centroid_predict(params, X):
    return -((X.unsqueeze(-2) - params["cent"].unsqueeze(-3)) ** 2).sum(-1)


FAMILIES: Dict[str, ModelFamily] = {
    "logreg": ModelFamily(
        "logreg", _logreg_init, _logreg_loss, None, _logreg_predict,
        {"lr": (0.3, 0.1, 0.03), "l2": (0.0, 1e-4, 1e-2)},
        init_keyless=True,
    ),
    "mlp": ModelFamily(
        "mlp", _mlp_init, _mlp_loss, None, _mlp_forward,
        {"lr": (0.01, 0.003, 0.001), "l2": (0.0, 1e-4), "width": (32, 64, 128), "depth": (1, 2)},
        shape_hps=("depth", "width"),
    ),
    "linear_svm": ModelFamily(
        "linear_svm", _logreg_init, _svm_loss, None, _logreg_predict,
        {"lr": (0.1, 0.03, 0.01), "l2": (1e-4, 1e-2)},
        init_keyless=True,
    ),
    "gnb": ModelFamily(
        "gnb", None, None, _gnb_fit, _gnb_predict,
        {"var_smoothing": (1e-9, 1e-6, 1e-3)},
    ),
    "centroid": ModelFamily(
        "centroid", None, None, _centroid_fit, _centroid_predict,
        {"shrinkage": (0.0, 0.2, 0.5)},
    ),
}


# ---------------------------------------------------------------------------
# masked counterparts for heterogeneous-shape cohort merging (DESIGN.md §12.3)
# ---------------------------------------------------------------------------

# Additive class-mask constant: finite (no inf-inf NaNs) yet large enough
# that exp(CLASS_MASK_NEG - max_logit) underflows to exactly 0.0 in float32,
# so a masked class contributes exactly nothing to softmax/hinge/argmax and
# its logit receives exactly zero gradient.
CLASS_MASK_NEG = -1e30


def _xent_masked(logits, y, w):
    """Row-weighted cross-entropy: sum(w * nll) / sum(w); padded rows enter
    as exact ``0.0`` terms of the sum."""
    return (_nll(logits, y) * w).sum(-1) / w.sum(-1)


def masked_loss(family: str, params, X, y, w, cmask, c, hp):
    """Row/class-masked counterpart of ``FAMILIES[family].loss``.

    ``w`` is a ``(N,)`` 0/1 row-validity weight and ``cmask`` a ``(c,)``
    additive class mask (0 for real classes, ``CLASS_MASK_NEG`` for
    padding); with a leading trial axis, one of each per trial."""
    fam = FAMILIES[family]
    logits = fam.predict(params, X) + cmask.unsqueeze(-2)
    if family == "linear_svm":
        data = (_hinge(logits, y) * w).sum(-1) / w.sum(-1)
        reg = hp["l2"] * _sq_sum(params["w"])
    elif family == "mlp":
        data = _xent_masked(logits, y, w)
        reg = hp["l2"] * _mlp_reg(params)
    elif family == "logreg":
        data = _xent_masked(logits, y, w)
        reg = hp["l2"] * _sq_sum(params["w"])
    else:
        raise ValueError(f"no masked loss for family {family!r}")
    return data + reg


def masked_fit(family: str, X, y, w, cmask, c, hp):
    """Row/class-masked counterpart of ``FAMILIES[family].fit_closed``:
    class statistics weight rows by ``w`` and the row count is ``w.sum()``;
    padded classes get ``CLASS_MASK_NEG`` priors (gnb) or are suppressed at
    prediction time via ``cmask`` (centroid)."""
    onehot = _one_hot(y, c) * w.unsqueeze(-1)
    n_rows = w.sum(-1, keepdim=True)
    if family == "gnb":
        params = _gnb_stats(onehot, X, n_rows, hp["var_smoothing"])
        params["prior"] = params["prior"] + cmask
        return params
    if family == "centroid":
        cnt = onehot.sum(-2).unsqueeze(-1)
        cent = (onehot.mT @ X) / cnt.clamp_min(1.0)
        overall = (w.unsqueeze(-1) * X).sum(-2, keepdim=True) / n_rows.unsqueeze(-1)
        return {"cent": _shrunk(cent, overall, hp["shrinkage"])}
    raise ValueError(f"no masked closed-form fit for family {family!r}")


def masked_accuracy(family: str, params, X, y, w, cmask) -> torch.Tensor:
    """Row-weighted accuracy with padded classes excluded from the argmax
    (a tensor: one per trial with a leading trial axis)."""
    logits = FAMILIES[family].predict(params, X) + cmask.unsqueeze(-2)
    return ((torch.argmax(logits, dim=-1) == y).to(torch.float32) * w).sum(-1) / w.sum(-1)


# ---------------------------------------------------------------------------
# training and evaluation
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, leaves):
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(go(x) for x in t)
        return next(it)

    return go(tree)


def adam_train(loss_fn, params0, lr, epochs: int, n_steps=None):
    """Full-batch Adam over ``epochs`` steps, the one trajectory both engine
    backends run (the reference's ``models.py:270-310``, op for op).

    ``loss_fn(params)`` returns a scalar, or one loss per trial for a stack
    of trials: the sum is differentiated, and since the trials' params are
    disjoint each trial gets exactly its own loss's gradient.  ``lr`` is a
    float or a per-trial ``(T,)`` tensor, broadcast over each leaf's
    trailing dims.  The bias corrections ``1 - 0.9**t`` and ``1 - 0.999**t``
    are float32 tensors, as JAX computes them, not Python doubles.

    ``n_steps`` is the step mask of continuous rung batching (DESIGN.md
    §13.1): an int truncates the run; a per-trial ``(T,)`` tensor keeps all
    ``epochs`` steps and, from step ``n_steps[i]`` on, selects trial *i*'s
    previous ``(params, m, v)`` with ``torch.where``, so each trial equals
    its own ``epochs=n_steps[i]`` run.  Nothing here waits for the host.

    Each step is ``_AdamStep``, run eagerly ``steps`` times.  On a card, a
    run of at least ``ADAM_GRAPH_MIN_STEPS`` steps (outside another capture)
    takes its first step eagerly, captures the second into a CUDA graph and
    replays it for the rest (``_adam_graphed``): the same operations in the
    same order, so the same trajectory, for one launch a step.  The replayed
    steps are added to the open span's ``graph_steps`` where its opener asked
    for the count (``_count_graph_steps``)."""
    flat = [p.detach().clone() for p in _leaves(params0)]
    dev = flat[0].device if flat else None
    masked = isinstance(n_steps, torch.Tensor)
    steps = epochs if n_steps is None or masked else min(epochs, int(n_steps))
    t = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    bc1 = 1 - torch.pow(torch.full((), 0.9, dtype=torch.float32, device=dev), t)
    bc2 = 1 - torch.pow(torch.full((), 0.999, dtype=torch.float32, device=dev), t)
    active = (torch.arange(steps, device=dev)[:, None] < n_steps[None, :]   # (steps, T)
              if masked else None)
    step = _AdamStep(loss_fn, params0, flat, [_per_trial(lr, x.ndim) for x in flat],
                     bc1, bc2, active)
    if (dev is not None and dev.type == "cuda" and steps >= ADAM_GRAPH_MIN_STEPS
            and not torch.cuda.is_current_stream_capturing()):
        _adam_graphed(step, steps)
    else:
        for _ in range(steps):
            step()
    return _rebuild(params0, [x.detach() for x in flat])


class _AdamStep:
    """One step of ``adam_train``, which a CUDA graph can capture: ``flat``
    and its moments ``m`` and ``v`` are static buffers updated in place, and
    the step's bias corrections (and step mask) are read at the device
    counter ``k``, which the step increments, so no value of the step comes
    from the host.  ``m.mul_(0.9).add_(0.1 * g)`` rounds as ``0.9 * m + 0.1 *
    g`` does; a masked step computes the new values out of place and selects
    them into the buffers."""

    def __init__(self, loss_fn, params0, flat, lrs, bc1, bc2, active=None):
        self.loss_fn, self.params0 = loss_fn, params0
        self.flat, self.lrs = flat, lrs
        self.m = [torch.zeros_like(x) for x in flat]
        self.v = [torch.zeros_like(x) for x in flat]
        self.bc = torch.stack((bc1, bc2), 1)                     # (steps, 2)
        self.active = active                                     # (steps, T) or None
        self.k = torch.zeros((1,), dtype=torch.int64, device=self.bc.device)
        for x in flat:
            x.requires_grad_(True)

    def __call__(self):
        loss = self.loss_fn(_rebuild(self.params0, self.flat))
        grads = torch.autograd.grad(loss.sum() if loss.ndim else loss, self.flat)
        with torch.no_grad():
            bc = self.bc.index_select(0, self.k)[0]
            b1, b2 = bc[0], bc[1]
            if self.active is None:
                for f, li, mi, vi, g in zip(self.flat, self.lrs, self.m, self.v, grads):
                    mi.mul_(0.9).add_(0.1 * g)
                    vi.mul_(0.999).add_(0.001 * g ** 2)
                    f.sub_(li * (mi / b1) / (torch.sqrt(vi / b2) + 1e-8))
            else:
                act = self.active.index_select(0, self.k)[0]
                for f, li, mi, vi, g in zip(self.flat, self.lrs, self.m, self.v, grads):
                    keep = _per_trial(act, f.ndim)
                    m_n = 0.9 * mi + 0.1 * g
                    v_n = 0.999 * vi + 0.001 * g ** 2
                    f_n = f - li * (m_n / b1) / (torch.sqrt(v_n / b2) + 1e-8)
                    torch.where(keep, f_n, f, out=f)
                    torch.where(keep, m_n, mi, out=mi)
                    torch.where(keep, v_n, vi, out=vi)
            self.k.add_(1)


def _adam_graphed(step: _AdamStep, steps: int) -> None:
    """Run ``steps`` steps of ``step``: the first eagerly on the side stream
    (a real step, and the warm-up capture needs: autograd's device thread,
    cuBLAS's workspace for that stream), one captured there, then ``steps -
    1`` replays on the caller's stream.  Nothing waits for the host.  The
    graph is freed when the call returns; launches still queued finish
    first."""
    dev = step.k.device
    side, holder = capture_resources(dev)
    caller = torch.cuda.current_stream(dev)
    side.wait_stream(caller)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        step()
        graph.capture_begin(pool=holder.pool(), capture_error_mode="thread_local")
        try:
            step()
        finally:
            graph.capture_end()
    caller.wait_stream(side)
    for _ in range(steps - 1):
        graph.replay()
    _count_graph_steps(steps - 1)


def _count_graph_steps(n: int) -> None:
    """Add ``n`` replayed steps to the open span's ``graph_steps``, where
    the span's opener asked for the count by opening it at 0 (the AutoML
    backends' ``automl.rung.issue``); any other span is left as it is."""
    sp = _trace.current_span()
    if sp is not None and "graph_steps" in sp["attrs"]:
        sp["attrs"]["graph_steps"] += n


def train_model(gen: torch.Generator, X, y, family: str, n_classes: int, hp: dict,
                epochs: int, init_params=None):
    """Train one trial.  ``gen`` draws the family's random init (MLP);
    ``init_params`` replaces the drawn init (the tests inject the reference's
    own initial params through it, since torch cannot replay its draws)."""
    fam = FAMILIES[family]
    if fam.fit_closed is not None:
        return fam.fit_closed(gen, X, y, n_classes, hp)
    params = (fam.init(gen, X.shape[1], n_classes, hp, X.device)
              if init_params is None else init_params)
    return adam_train(lambda p: fam.loss(p, X, y, n_classes, hp), params, hp["lr"], epochs)


def predict_model(params, X, family: str):
    return FAMILIES[family].predict(params, X)


def accuracy(params, X, y, family: str) -> float:
    with torch.no_grad():
        logits = predict_model(params, X, family)
        return float((torch.argmax(logits, dim=-1) == y).to(torch.float32).mean())
