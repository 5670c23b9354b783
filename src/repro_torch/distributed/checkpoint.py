"""Atomic, integrity-checked checkpoints on disk (DESIGN.md §14.5), after
the JAX package's ``distributed/checkpoint.py``, on the same on-disk format,
so either package restores the other's checkpoints::

  <dir>/step_<N>/
      manifest.json      — tree structure, shapes, dtypes, per-leaf sha256
      leaf_<i>.npy       — one file per tree leaf
      COMMIT             — written last; a checkpoint without it is ignored

Writes go to ``step_<N>.tmp`` and are renamed into place, so a crash mid-
write never corrupts the latest checkpoint; ``keep`` prunes the oldest
complete ones.  The restores verify the hashes and fall back to the
previous complete checkpoint on a mismatch.

A tree is nested dicts (leaves in sorted key order, as ``jax.tree`` walks
them), lists, tuples (a ``TrainState`` among them) and ``Params`` (walked as
the dict of its parameters and children, a layer list as a list) over numpy
arrays or tensors (copied to the host).  A ``bfloat16`` leaf, which numpy
lacks, is stored as the reference stores it: its bytes as a uint8 array,
the logical dtype and shape in the manifest.

* ``restore_latest(dir, template)`` returns the tree typed by the template:
  its structure, each leaf on the template leaf's device in its dtype.
* ``restore_latest_untyped`` returns the leaves as host arrays in manifest
  order (a ``bfloat16`` leaf as a CPU ``torch.bfloat16`` tensor).
* ``CheckpointManager.save_async`` copies the state to the host once and
  writes it on a thread.

Leaves are written, and read and verified, by a pool of threads: each leaf
is hashed as it is written and as it is read, never read back, so its
bytes cross memory once and the hashing, which bounds the rate of a large
state, runs on several cores.

* ``restore_resharded(dir, template, shardings)`` restores as
  ``restore_latest`` does, then places each leaf as a DTensor with its
  ``sharding.NamedSharding`` (mesh and placements): the elastic restore
  onto a new mesh.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import Params

__all__ = ["save_checkpoint", "restore_latest", "restore_latest_untyped", "latest_step",
           "restore_resharded", "CheckpointManager"]

_NATIVE_DTYPES = {
    "float64", "float32", "float16", "int64", "int32", "int16", "int8",
    "uint64", "uint32", "uint16", "uint8", "bool",
}
# dtypes numpy lacks, stored as uint8 views (the reference's ml_dtypes names)
_VIEW_DTYPES = {"bfloat16": torch.bfloat16}
_IO_THREADS = min(8, os.cpu_count() or 1)


def _flatten(tree: Any, leaves: List[Any]) -> str:
    """Append ``tree``'s leaves to ``leaves`` in ``jax.tree`` order and
    return the structure's description (``*`` for a leaf)."""
    if isinstance(tree, Params):
        tree = tree.entries()
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        if isinstance(tree, (list, nn.ModuleList)):
            return f"[{inner}]"
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if tree is None:
        return "None"
    leaves.append(tree)
    return "*"


def _unflatten(template: Any, leaves: Iterator[Any]) -> Any:
    """``template``'s structure over the next leaves of ``leaves``."""
    if isinstance(template, Params):
        named = template.entries()
        return Params({k: _unflatten(named[k], leaves) for k in sorted(named)})
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, nn.ModuleList)):
        return [_unflatten(v, leaves) for v in template]
    if isinstance(template, tuple):
        values = [_unflatten(v, leaves) for v in template]
        return type(template)(*values) if hasattr(template, "_fields") else tuple(values)
    if template is None:
        return None
    return next(leaves)


def _host(leaf: Any) -> Tuple[np.ndarray, List[int], str]:
    """The array written for ``leaf``, its logical shape and dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            data = t.contiguous().reshape(-1) if t.dim() == 0 else t.contiguous()
            return data.view(torch.uint8).numpy(), list(t.shape), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if str(arr.dtype) not in _NATIVE_DTYPES:
        raise TypeError(f"checkpoint leaf of dtype {arr.dtype} has no native "
                        f"numpy dtype")
    return arr, list(arr.shape), str(arr.dtype)


def _steps(ckpt_dir: Path) -> List[int]:
    """Steps of the complete (committed) checkpoints under ``ckpt_dir``."""
    return sorted(int(p.name.split("_")[1])
                  for p in ckpt_dir.glob("step_????????")
                  if (p / "COMMIT").exists())


class _HashingFile:
    """A binary file that hashes what is written to it."""

    def __init__(self, f):
        self.f, self.sha = f, hashlib.sha256()

    def write(self, b) -> int:
        self.sha.update(b)
        return self.f.write(b)


def _write_leaf(path: Path, i: int, leaf: Any) -> dict:
    """Write leaf ``i`` as ``leaf_<i>.npy`` (the bytes ``np.save`` writes to a
    path) and return its manifest record."""
    arr, shape, dtype = _host(leaf)
    fname = f"leaf_{i}.npy"
    with open(path / fname, "wb") as f:
        out = _HashingFile(f)
        np.save(out, arr)
    return {"file": fname, "shape": shape, "dtype": dtype, "sha256": out.sha.hexdigest()}


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
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        records = list(pool.map(lambda i: _write_leaf(tmp, i, leaves[i]), range(len(leaves))))
    manifest = {"step": step, "treedef": treedef, "leaves": records}
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


def _load_leaf(path: Path, rec: dict, verify: bool):
    """One leaf of a checkpoint directory: a numpy array, or a CPU tensor
    for a dtype numpy lacks."""
    f = path / rec["file"]
    data = f.read_bytes()
    if verify and hashlib.sha256(data).hexdigest() != rec["sha256"]:
        raise IOError(f"hash mismatch in {f}")
    arr = np.load(io.BytesIO(data))
    if rec["dtype"] in _VIEW_DTYPES:
        out = torch.from_numpy(arr).view(_VIEW_DTYPES[rec["dtype"]]).reshape(rec["shape"])
    elif rec["dtype"] in _NATIVE_DTYPES:
        out = arr
    else:
        raise TypeError(f"checkpoint leaf {f} has dtype {rec['dtype']}, which the port "
                        f"does not read")
    if list(out.shape) != list(rec["shape"]):
        raise ValueError(f"shape mismatch {tuple(out.shape)} vs {rec['shape']}")
    return out


def _typed(arr, like):
    """``arr`` (numpy or a CPU tensor) on ``like``'s device in its dtype."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    return np.asarray(arr, dtype=np.asarray(like).dtype)


def restore_latest(ckpt_dir, template: Any, *, verify: bool = True
                   ) -> Optional[Tuple[Any, int]]:
    """Restore the newest complete, integrity-valid checkpoint as
    ``(tree, step)``: ``template``'s structure, each leaf on its template
    leaf's device and in its dtype.  A checkpoint whose hashes, leaf count
    or shapes do not match is skipped in favour of an older complete one;
    None when none is left."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    like: List[Any] = []
    _flatten(template, like)
    for s in reversed(_steps(ckpt_dir)):
        path = ckpt_dir / f"step_{s:08d}"
        try:
            manifest = json.loads((path / "manifest.json").read_text())
            if len(manifest["leaves"]) != len(like):
                raise ValueError("checkpoint/template leaf count mismatch")

            def load(i):
                arr = _load_leaf(path, manifest["leaves"][i], verify)
                if list(arr.shape) != list(np.shape(like[i])):
                    raise ValueError(f"shape mismatch {tuple(arr.shape)} vs "
                                     f"{np.shape(like[i])}")
                return _typed(arr, like[i])
            with ThreadPoolExecutor(_IO_THREADS) as pool:
                out = list(pool.map(load, range(len(like))))
            return _unflatten(template, iter(out)), manifest["step"]
        except (IOError, ValueError):
            continue
    return None


def restore_latest_untyped(ckpt_dir, *, verify: bool = True
                           ) -> Optional[Tuple[List[Any], int]]:
    """Restore the newest complete checkpoint without a tree template.

    Returns ``(leaves, step)`` with the leaves as host arrays in manifest
    order (a ``bfloat16`` leaf as a CPU ``torch.bfloat16`` tensor) — for
    callers whose state is an opaque blob whose shape cannot be known
    before reading it (the serving tier checkpoints its wire-encoded
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
            with ThreadPoolExecutor(_IO_THREADS) as pool:
                leaves = list(pool.map(lambda rec: _load_leaf(path, rec, verify),
                                       manifest["leaves"]))
            return leaves, manifest["step"]
        except (IOError, ValueError, KeyError, json.JSONDecodeError):
            continue
    return None


def restore_resharded(ckpt_dir, template: Any, shardings: Any
                      ) -> Optional[Tuple[Any, int]]:
    """Elastic restore: ``restore_latest``, then each leaf placed with its
    sharding (a tree of ``sharding.NamedSharding`` matching ``template``,
    as ``sharding.tree_shardings`` makes) as a DTensor on that mesh.  Each
    leaf's global value is the saved one."""
    from torch.distributed.tensor import distribute_tensor
    res = restore_latest(ckpt_dir, template)
    if res is None:
        return None
    tree, step = res
    leaves: List[Any] = []
    placements: List[Any] = []
    _flatten(tree, leaves)
    _flatten(shardings, placements)
    if len(leaves) != len(placements):
        raise ValueError(f"restore_resharded: {len(placements)} shardings for "
                         f"{len(leaves)} leaves")
    placed = [distribute_tensor(torch.as_tensor(leaf).to(sh.mesh.device_type), sh.mesh,
                                list(sh.placements))
              for leaf, sh in zip(leaves, placements)]
    return _unflatten(tree, iter(placed)), step


def _to_host(tree: Any) -> Any:
    """``tree`` with every leaf copied to the host (a copy even of a CPU
    tensor, which the train step goes on updating in place)."""
    leaves: List[Any] = []
    _flatten(tree, leaves)
    host = [leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
            else np.array(leaf) for leaf in leaves]
    return _unflatten(tree, iter(host))


class CheckpointManager:
    """Asynchronous checkpoints: one copy of the state to the host, then the
    write on a worker thread, so the train loop never waits on the disk.

    ``save_async`` waits for the previous write before it copies (the
    reference copies first, ``checkpoint.py:205-209``): the state copied is
    the same, since the loop is blocked in the call, and only one host copy
    is alive at a time."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, state: Any) -> None:
        self.wait()
        host_state = _to_host(state)
        self._thread = threading.Thread(target=self._write, args=(step, host_state),
                                        daemon=True)
        self._thread.start()

    def _write(self, step: int, host_state: Any) -> None:
        try:
            save_checkpoint(self.dir, step, host_state, keep=self.keep)
        except Exception as exc:          # re-raised by wait() in the caller's thread
            self._error = exc

    def wait(self) -> None:
        """Wait for the write in flight; raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
