"""Carry state across from the JAX package, through numpy.

The port imports nothing of the JAX package; a caller who holds the
reference's results as numpy arrays (``np.asarray(jax_array)``) turns them
into the port's tensors here:

* ``coded_from_numpy`` — a factorized dataset (the fields of the
  reference's ``CodedDataset``);
* ``params_from_numpy`` — AutoML params of one family, as the reference's
  trees hold them: ``logreg``/``linear_svm`` ``{"w", "b"}``, ``mlp``
  ``{"layers": [{"w", "b"}, ...]}``, ``gnb`` ``{"mean", "var", "prior"}``,
  ``centroid`` ``{"cent"}``;
* ``lm_params_from_numpy`` — the parameters of a dense, ssm or hybrid LM
  (``models/lm.py``) from the reference's stacked param tree.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.measures import CodedDataset
from .device import DeviceLike, resolve_device
from .models.config import ModelConfig
from .models.layers import Params
from .models.lm import PORTED_FAMILIES

__all__ = ["coded_from_numpy", "params_from_numpy", "lm_params_from_numpy"]

_PARAM_KEYS = {
    "logreg": ("w", "b"),
    "linear_svm": ("w", "b"),
    "gnb": ("mean", "var", "prior"),
    "centroid": ("cent",),
}


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype), device=device)   # a writable copy


def coded_from_numpy(codes, values, n_bins, target_col: int, max_bins: int,
                     device: DeviceLike = None) -> CodedDataset:
    """A ``CodedDataset`` on ``device`` from numpy arrays."""
    dev = resolve_device(device)
    return CodedDataset(codes=_tensor(codes, np.int32, dev),
                        values=_tensor(values, np.float32, dev),
                        n_bins=_tensor(n_bins, np.int32, dev),
                        target_col=int(target_col), max_bins=int(max_bins))


def params_from_numpy(family: str, tree, device: DeviceLike = None) -> dict:
    """The port's params of ``family`` (float32 tensors on ``device``) from
    the reference's param tree of numpy arrays."""
    dev = resolve_device(device)
    if family == "mlp":
        return {"layers": [{"w": _tensor(lyr["w"], np.float32, dev),
                            "b": _tensor(lyr["b"], np.float32, dev)}
                           for lyr in tree["layers"]]}
    try:
        keys = _PARAM_KEYS[family]
    except KeyError:
        raise ValueError(f"unknown model family {family!r}") from None
    return {k: _tensor(tree[k], np.float32, dev) for k in keys}


def _lm_leaf(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":        # ml_dtypes' bfloat16: same bits as torch's
        t = torch.from_numpy(np.ascontiguousarray(x).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=dtype)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def lm_params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = None) -> Params:
    """The port's LM parameters (``models.lm.init_params``' layout) on
    ``device`` from the reference's param tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``).

    The leaves under ``layers`` are stacked (L, ...) and are unstacked into
    one entry per layer; ``embed``, ``final_norm``, ``lm_head`` (untied
    embeddings) and ``shared_attn`` (hybrid) come as they are.  Every leaf
    is stored in ``cfg.param_dtype``."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet (ROADMAP A11)")
    dev = resolve_device(device)
    leaf = lambda x: _lm_leaf(x, cfg.param_dtype, dev)
    out = {k: (_map(leaf, v) if isinstance(v, dict) else leaf(v))
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(lambda a: leaf(np.asarray(a)[i]), tree["layers"])
                     for i in range(cfg.n_layers)]
    return Params(out)
