"""Model families of the AutoML substrate in PyTorch (DESIGN.md §5.4, §10.1).

The port of the JAX package's ``automl/models.py``.  Each family implements
init / loss / predict (or a closed-form fit) on dense ``(N, d)`` float32
features and int64 labels; params are dicts of tensors (``{"w", "b"}``,
``{"layers": [{"w", "b"}, ...]}``, ...), the same trees as the reference.
Gradients come from ``torch.autograd`` in place of ``jax.grad``.

Training is full-batch Adam (``adam_train``), a Python loop over steps whose
tensors stay on the device.  Float32 matmuls run in full float32: the port
turns TF32 off when it resolves a CUDA device (``device.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = ["FAMILIES", "ModelFamily", "adam_train", "train_model",
           "predict_model", "accuracy"]


class ModelFamily(NamedTuple):
    name: str
    init: Optional[Callable[..., Any]]
    loss: Optional[Callable[..., torch.Tensor]]   # None => closed-form fit
    fit_closed: Optional[Callable[..., Any]]
    predict: Callable[..., torch.Tensor]
    hp_grid: Dict[str, tuple]


# ---------------------------------------------------------------------------
# gradient-trained families
# ---------------------------------------------------------------------------


def _xent(logits, y):
    return -F.log_softmax(logits, dim=-1).gather(1, y[:, None]).mean()


def _logreg_init(gen, d, c, hp, device):
    return {"w": torch.zeros((d, c), device=device), "b": torch.zeros((c,), device=device)}


def _logreg_loss(params, X, y, c, hp):
    logits = X @ params["w"] + params["b"]
    return _xent(logits, y) + hp["l2"] * (params["w"] ** 2).sum()


def _logreg_predict(params, X):
    return X @ params["w"] + params["b"]


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
        h = h @ lyr["w"] + lyr["b"]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def _mlp_loss(params, X, y, c, hp):
    reg = sum((lyr["w"] ** 2).sum() for lyr in params["layers"])
    return _xent(_mlp_forward(params, X), y) + hp["l2"] * reg


def _svm_loss(params, X, y, c, hp):
    logits = X @ params["w"] + params["b"]
    correct = logits.gather(1, y[:, None])
    margins = torch.clamp_min(logits - correct + 1.0, 0.0)
    # the true class's margin is zeroed and kept out of the gradient, as the
    # reference's ``margins.at[arange, y].set(0.0)`` does: a mask, not an
    # in-place write on a tensor autograd needs
    own = F.one_hot(y, logits.shape[1]).bool()
    margins = torch.where(own, 0.0, margins)
    return margins.sum(1).mean() + hp["l2"] * (params["w"] ** 2).sum()


# ---------------------------------------------------------------------------
# closed-form families
# ---------------------------------------------------------------------------


def _gnb_fit(gen, X, y, c, hp):
    eps = hp["var_smoothing"]
    onehot = F.one_hot(y, c).to(torch.float32)               # (N, c)
    cnt = onehot.sum(0)[:, None]                             # (c, 1)
    mean = (onehot.T @ X) / cnt.clamp_min(1.0)               # (c, d)
    sq = (onehot.T @ (X ** 2)) / cnt.clamp_min(1.0)
    var = (sq - mean ** 2).clamp_min(0.0) + eps
    prior = torch.log((cnt[:, 0] / X.shape[0]).clamp_min(1e-12))
    return {"mean": mean, "var": var, "prior": prior}


def _gnb_predict(params, X):
    # log N(x | mu, var) summed over dims + log prior
    mu, var, prior = params["mean"], params["var"], params["prior"]
    ll = -0.5 * (((X[:, None, :] - mu[None]) ** 2) / var[None]
                 + torch.log(2 * torch.pi * var)[None]).sum(-1)
    return ll + prior[None]


def _centroid_fit(gen, X, y, c, hp):
    onehot = F.one_hot(y, c).to(torch.float32)
    cnt = onehot.sum(0)[:, None]
    cent = (onehot.T @ X) / cnt.clamp_min(1.0)
    overall = X.mean(0, keepdim=True)
    return {"cent": overall + (cent - overall) * (1.0 - hp["shrinkage"])}


def _centroid_predict(params, X):
    return -((X[:, None, :] - params["cent"][None]) ** 2).sum(-1)


FAMILIES: Dict[str, ModelFamily] = {
    "logreg": ModelFamily(
        "logreg", _logreg_init, _logreg_loss, None, _logreg_predict,
        {"lr": (0.3, 0.1, 0.03), "l2": (0.0, 1e-4, 1e-2)},
    ),
    "mlp": ModelFamily(
        "mlp", _mlp_init, _mlp_loss, None, _mlp_forward,
        {"lr": (0.01, 0.003, 0.001), "l2": (0.0, 1e-4), "width": (32, 64, 128), "depth": (1, 2)},
    ),
    "linear_svm": ModelFamily(
        "linear_svm", _logreg_init, _svm_loss, None, _logreg_predict,
        {"lr": (0.1, 0.03, 0.01), "l2": (1e-4, 1e-2)},
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


def adam_train(loss_fn, params0, lr, epochs: int, n_steps: Optional[int] = None):
    """Full-batch Adam over ``epochs`` steps, the reference's trajectory.

    ``loss_fn(params) -> scalar``.  The update is the reference's op for op
    (``models.py:292-306``); its bias corrections ``1 - 0.9**t`` and
    ``1 - 0.999**t`` are computed in float32 tensors, as JAX computes them,
    not in Python doubles.  ``n_steps`` is the per-trial step mask of
    continuous rung batching: steps ``t >= n_steps`` leave the params and
    moments unchanged, so the result equals an ``epochs=n_steps`` run."""
    flat = [p.detach().clone() for p in _leaves(params0)]
    dev = flat[0].device if flat else None
    m = [torch.zeros_like(x) for x in flat]
    v = [torch.zeros_like(x) for x in flat]
    steps = epochs if n_steps is None else min(epochs, int(n_steps))
    t = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    bc1 = 1 - torch.pow(torch.tensor(0.9, dtype=torch.float32, device=dev), t)
    bc2 = 1 - torch.pow(torch.tensor(0.999, dtype=torch.float32, device=dev), t)
    for i in range(steps):
        leaves = [x.requires_grad_(True) for x in flat]
        loss = loss_fn(_rebuild(params0, leaves))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            m = [0.9 * mi + 0.1 * gi for mi, gi in zip(m, grads)]
            v = [0.999 * vi + 0.001 * gi ** 2 for vi, gi in zip(v, grads)]
            flat = [fi - lr * (mi / bc1[i]) / (torch.sqrt(vi / bc2[i]) + 1e-8)
                    for fi, mi, vi in zip(flat, m, v)]
    return _rebuild(params0, [x.detach() for x in flat])


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
        return float((torch.argmax(logits, dim=1) == y).to(torch.float32).mean())
