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
* ``lm_params_from_numpy`` — the parameters of an LM of any family
  (``models/lm.py``, ``models/encdec.py``) from the reference's stacked
  param tree.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.measures import CodedDataset
from .device import DeviceLike, resolve_device
from .models.config import ModelConfig
from .models.layers import Params

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


# leaves the reference keeps in float32 whatever ``param_dtype`` is (moe.py:31, :43)
_FLOAT32_LEAVES = ("router", "shared_gate")


def _map(fn, tree):
    """``fn(name, leaf)`` over a nested dict, keeping its structure."""
    return {k: _map(fn, v) if isinstance(v, dict) else fn(k, v) for k, v in tree.items()}


def lm_params_from_numpy(tree, cfg: ModelConfig, device: DeviceLike = None) -> Params:
    """The port's LM parameters (``models.lm.init_params``' layout, or
    ``models.encdec.init_params``' for the encdec family) on ``device`` from
    the reference's param tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``).

    The stacked leaves (L, ...) are unstacked into one entry per layer:
    ``layers`` (``n_layers``), or for encdec ``enc_layers`` (``n_enc_layers``)
    and ``dec_layers`` (``n_layers``); every other entry (``embed``,
    ``final_norm``, ``lm_head``, ``enc_norm``, ``shared_attn``) comes as it
    is.  Every leaf is stored in ``cfg.param_dtype``, but the MoE router and
    shared-expert gate, which stay float32."""
    dev = resolve_device(device)
    stacked = ({"enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_layers}
               if cfg.family == "encdec" else {"layers": cfg.n_layers})
    leaf = lambda name, x: _lm_leaf(
        x, torch.float32 if name in _FLOAT32_LEAVES else cfg.param_dtype, dev)
    out = {k: (_map(leaf, v) if isinstance(v, dict) else leaf(k, v))
           for k, v in tree.items() if k not in stacked}
    for key, n in stacked.items():
        out[key] = [_map(lambda name, a: leaf(name, np.asarray(a)[i]), tree[key])
                    for i in range(n)]
    return Params(out)
