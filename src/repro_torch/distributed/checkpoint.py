"""Atomic, integrity-checked checkpoints on disk (DESIGN.md §14.5).

The port of what the serving tier needs of the JAX package's
``distributed/checkpoint.py``, on the same on-disk format, so either
package restores the other's checkpoints::

  <dir>/step_<N>/
      manifest.json      — tree structure, shapes, dtypes, per-leaf sha256
      leaf_<i>.npy       — one file per tree leaf
      COMMIT             — written last; a checkpoint without it is ignored

Writes go to ``step_<N>.tmp`` and are renamed into place, so a crash mid-
write never corrupts the latest checkpoint; ``keep`` prunes the oldest
complete ones.  ``restore_latest_untyped`` verifies the hashes and falls
back to the previous complete checkpoint on a mismatch.

A tree is nested dicts (leaves in sorted key order, as ``jax.tree`` walks
them), lists and tuples over numpy arrays or tensors (copied to the host).
Leaves keep numpy's own dtypes: a dtype numpy lacks (``bfloat16``) raises
``TypeError``.  The template-typed ``restore_latest``, ``restore_resharded``
and the asynchronous ``CheckpointManager`` serve training and come with it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_latest_untyped", "latest_step"]

_NATIVE_DTYPES = {
    "float64", "float32", "float16", "int64", "int32", "int16", "int8",
    "uint64", "uint32", "uint16", "uint8", "bool",
}


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """Append ``tree``'s leaves to ``leaves`` in ``jax.tree`` order and
    return the structure's description (``*`` for a leaf)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        if isinstance(tree, list):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if tree is None:
        return "None"
    leaves.append(tree)
    return "*"


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("checkpoint leaf of dtype torch.bfloat16 has no "
                            "native numpy dtype")
        arr = leaf.detach().cpu().numpy()
    else:
        arr = np.asarray(leaf)
    if str(arr.dtype) not in _NATIVE_DTYPES:
        raise TypeError(f"checkpoint leaf of dtype {arr.dtype} has no native "
                        f"numpy dtype")
    return arr


def _steps(ckpt_dir: Path) -> List[int]:
    """Steps of the complete (committed) checkpoints under ``ckpt_dir``."""
    return sorted(int(p.name.split("_")[1])
                  for p in ckpt_dir.glob("step_????????")
                  if (p / "COMMIT").exists())


def save_checkpoint(ckpt_dir, step: int, state: Any, *, keep: int = 3) -> Path:
    """Write ``state`` as ``<ckpt_dir>/step_<step>`` and keep the newest
    ``keep`` complete checkpoints."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves: List[Any] = []
    treedef = f"PyTreeDef({_flatten(state, leaves)})"
    manifest = {"step": step, "treedef": treedef, "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        fname = f"leaf_{i}.npy"
        np.save(tmp / fname, arr)
        digest = hashlib.sha256((tmp / fname).read_bytes()).hexdigest()
        manifest["leaves"].append(
            {"file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype),
             "sha256": digest})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    for s in _steps(ckpt_dir)[:-keep]:          # retention
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_latest_untyped(ckpt_dir, *, verify: bool = True
                           ) -> Optional[Tuple[List[np.ndarray], int]]:
    """Restore the newest complete checkpoint without a tree template.

    Returns ``(leaves, step)`` with the leaves as host arrays in manifest
    order — for callers whose state is an opaque blob whose shape cannot be
    known before reading it (the serving tier checkpoints its wire-encoded
    scheduler state as one variable-length uint8 leaf).  A checkpoint whose
    hashes, shapes or manifest do not check out is skipped in favour of an
    older complete one; None when none is left."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    for s in reversed(_steps(ckpt_dir)):
        path = ckpt_dir / f"step_{s:08d}"
        try:
            manifest = json.loads((path / "manifest.json").read_text())
            leaves = []
            for rec in manifest["leaves"]:
                if rec["dtype"] not in _NATIVE_DTYPES:
                    raise TypeError(f"checkpoint leaf {path / rec['file']} has "
                                    f"dtype {rec['dtype']}, not a native numpy one")
                f = path / rec["file"]
                if verify:
                    digest = hashlib.sha256(f.read_bytes()).hexdigest()
                    if digest != rec["sha256"]:
                        raise IOError(f"hash mismatch in {f}")
                arr = np.load(f)
                if list(arr.shape) != list(rec["shape"]):
                    raise ValueError(
                        f"shape mismatch {arr.shape} vs {rec['shape']}")
                leaves.append(arr)
            return leaves, manifest["step"]
        except (IOError, ValueError, KeyError, json.JSONDecodeError):
            continue
    return None
