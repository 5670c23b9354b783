"""Versioned wire serialization for the cross-process serving tier
(DESIGN.md §14.2).

The port of the JAX package's ``service/wire.py``, on the same format, so
either package's ``loads`` reads the other's payloads.  One
self-describing binary format carries everything the transport ships
between the front end and its workers — ``TrialCohort`` payloads, scored
rung results, ``SearchState`` snapshots, whole-scheduler checkpoints::

    blob = dumps(obj)          # bytes
    obj2 = loads(blob)         # round-trips exactly

Layout::

    b"SBWR" | u32 version | u32 header_len | header JSON | buffer bytes...

The header is a JSON tree in which every value is either a JSON primitive
or a tagged node (``{"__a__": i}`` array buffer reference, ``{"__t__":
[...]}`` tuple, ``{"__d__": [[k, v], ...]}`` dict, ``{"__dc__": "module:
Class", ...}`` dataclass).  Array data travels as raw little-endian
buffers after the header, so every array round-trips bit-exactly.  A tree
of numpy arrays, numpy scalars, bytes, tuples, lists, dicts and JSON
primitives encodes to the same bytes as the reference's ``dumps``.

Versioning: ``loads`` rejects any payload whose version differs from
``WIRE_VERSION`` with a ``WireVersionError`` naming both versions.
Version 2 added the optional ``trace`` header field (the cross-process
span context, ``obs/trace.child_ctx``); version 3 marks the experience
store in scheduler snapshots.  Each bump stops an older reader from
silently dropping what the newer writer sent.

What differs from the reference:

* A ``torch.Tensor``, on any device, is copied to the host and encoded as
  the numpy array of the same dtype and bytes; ``loads`` returns host
  numpy arrays, and moving them to a device is the caller's job.  A dtype
  numpy lacks (``bfloat16``) raises ``WireError`` by name: nothing this
  tier ships has one.
* Random state does not travel: a ``torch.Generator`` raises
  ``WireError`` by name, and so does a reference payload's ``__key__``
  (JAX PRNG key) node.  Jobs and searches carry an int seed instead.
* Dataclasses and namedtuples are encoded by qualified name and
  re-imported on decode from ``repro_torch.*`` modules only: a
  ``"repro."`` tag (the reference's) is refused before anything is
  imported, so decoding never pulls in the JAX package.  Callables (the
  batched backend's lazy param thunks) are not serializable — holders
  materialize them first (``engine.search_snapshot`` does).
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import struct
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["WIRE_VERSION", "WireError", "WireVersionError", "dumps", "loads",
           "kind_of", "trace_of"]

MAGIC = b"SBWR"
WIRE_VERSION = 3

# dataclass decoding is restricted to this package's own modules
_DC_MODULE_PREFIX = "repro_torch."


class WireError(ValueError):
    """Malformed or unserializable wire payload."""


class WireVersionError(WireError):
    """Payload speaks a wire version this build does not."""


def _tensor_array(obj: torch.Tensor, path: str) -> np.ndarray:
    """A tensor's host numpy array of the same dtype and bytes."""
    host = obj.detach().resolve_conj().resolve_neg().cpu()
    try:
        return host.numpy()
    except TypeError:
        raise WireError(
            f"not wire-serializable at {path}: a {obj.dtype} tensor has no "
            f"numpy dtype (convert it, e.g. to float32, before shipping)"
        ) from None


def _enc(obj: Any, bufs: List[np.ndarray], path: str) -> Any:
    """Encode ``obj`` into a JSON-safe node, appending array buffers."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.ndarray):
        bufs.append(np.ascontiguousarray(obj))
        return {"__a__": len(bufs) - 1}
    if isinstance(obj, np.generic):           # numpy scalar: keep its dtype
        # np.asarray keeps the 0-d shape (ascontiguousarray would force 1-d)
        bufs.append(np.asarray(obj))
        return {"__a__": len(bufs) - 1, "scalar": True}
    if isinstance(obj, torch.Tensor):
        # as the reference encodes a device array: the host array's bytes
        bufs.append(np.ascontiguousarray(np.asarray(_tensor_array(obj, path))))
        return {"__a__": len(bufs) - 1}
    if isinstance(obj, torch.Generator):
        raise WireError(
            f"not wire-serializable at {path}: torch.Generator (random state "
            f"does not travel; ship the int seed it was made from)")
    if isinstance(obj, bytes):
        bufs.append(np.frombuffer(obj, dtype=np.uint8))
        return {"__b__": len(bufs) - 1}
    if isinstance(obj, tuple):
        if hasattr(obj, "_fields"):        # typed NamedTuple, by qualname
            cls = type(obj)
            if not cls.__module__.startswith(_DC_MODULE_PREFIX):
                raise WireError(
                    f"refusing to wire-encode non-repro_torch namedtuple "
                    f"{cls.__module__}:{cls.__qualname__} at {path}")
            return {"__nt__": f"{cls.__module__}:{cls.__qualname__}",
                    "f": [_enc(v, bufs, f"{path}.{name}")
                          for name, v in zip(obj._fields, obj)]}
        return {"__t__": [_enc(v, bufs, f"{path}[{i}]")
                          for i, v in enumerate(obj)]}
    if isinstance(obj, list):
        return {"__l__": [_enc(v, bufs, f"{path}[{i}]")
                          for i, v in enumerate(obj)]}
    if isinstance(obj, dict):
        return {"__d__": [[_enc(k, bufs, f"{path}.key"),
                           _enc(v, bufs, f"{path}[{k!r}]")]
                          for k, v in obj.items()]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        if not cls.__module__.startswith(_DC_MODULE_PREFIX):
            raise WireError(
                f"refusing to wire-encode non-repro_torch dataclass "
                f"{cls.__module__}:{cls.__qualname__} at {path}")
        fields = [[f.name, _enc(getattr(obj, f.name), bufs,
                                f"{path}.{f.name}")]
                  for f in dataclasses.fields(obj)]
        return {"__dc__": f"{cls.__module__}:{cls.__qualname__}", "f": fields}
    raise WireError(
        f"not wire-serializable at {path}: {type(obj).__module__}."
        f"{type(obj).__qualname__} (materialize callables / convert to "
        f"arrays before shipping)")


def _resolve_class(tag: str, what: str):
    """The class a ``module:Qualname`` tag names; the module prefix is
    checked before anything is imported."""
    modname, _, qualname = tag.partition(":")
    if not modname.startswith(_DC_MODULE_PREFIX):
        raise WireError(f"wire payload names non-repro_torch {what} {tag!r}")
    obj = importlib.import_module(modname)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _dec(node: Any, bufs: List[np.ndarray]):
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    if not isinstance(node, dict):
        raise WireError(f"malformed wire node: {node!r}")
    if "__a__" in node:
        arr = bufs[node["__a__"]]
        return arr[()] if node.get("scalar") else arr
    if "__key__" in node:
        raise WireError(
            "wire payload holds a JAX PRNG key (__key__ node); this build "
            "carries int seeds, not keys")
    if "__b__" in node:
        return bufs[node["__b__"]].tobytes()
    if "__t__" in node:
        return tuple(_dec(v, bufs) for v in node["__t__"])
    if "__nt__" in node:
        cls = _resolve_class(node["__nt__"], "namedtuple")
        return cls(*(_dec(v, bufs) for v in node["f"]))
    if "__l__" in node:
        return [_dec(v, bufs) for v in node["__l__"]]
    if "__d__" in node:
        return {_dec(k, bufs): _dec(v, bufs) for k, v in node["__d__"]}
    if "__dc__" in node:
        cls = _resolve_class(node["__dc__"], "dataclass")
        if not dataclasses.is_dataclass(cls):
            raise WireError(f"{node['__dc__']!r} is not a dataclass")
        return cls(**{name: _dec(v, bufs) for name, v in node["f"]})
    raise WireError(f"unknown wire node tags: {sorted(node)}")


def dumps(obj: Any, *, kind: str = "", trace: Optional[dict] = None) -> bytes:
    """Serialize ``obj`` to a versioned wire payload.

    ``trace`` is an optional JSON-safe span-propagation context
    (``obs/trace.child_ctx``) carried in the header — readable via
    ``trace_of`` without decoding the buffers, so a worker can parent its
    spans before paying for deserialization."""
    bufs: List[np.ndarray] = []
    tree = _enc(obj, bufs, "$")
    header = {
        "v": WIRE_VERSION,
        "kind": kind,
        "obj": tree,
        "bufs": [{"d": a.dtype.str, "s": list(a.shape)} for a in bufs],
    }
    if trace is not None:
        header["trace"] = trace
    hbytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    parts = [MAGIC, struct.pack("<II", WIRE_VERSION, len(hbytes)), hbytes]
    parts.extend(a.tobytes() for a in bufs)
    return b"".join(parts)


def _read_header(data: bytes) -> Tuple[dict, int]:
    if len(data) < 12 or data[:4] != MAGIC:
        raise WireError("not a SubStrat wire payload (bad magic)")
    version, hlen = struct.unpack_from("<II", data, 4)
    if version != WIRE_VERSION:
        raise WireVersionError(
            f"unsupported wire version {version}; this build speaks "
            f"version {WIRE_VERSION} — upgrade the older endpoint")
    if len(data) < 12 + hlen:
        raise WireError("truncated wire payload (header)")
    try:
        header = json.loads(data[12:12 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"corrupt wire header: {e}") from None
    return header, 12 + hlen


def kind_of(data: bytes) -> str:
    """Peek a payload's ``kind`` tag without decoding its buffers."""
    header, _ = _read_header(data)
    return header.get("kind", "")


def trace_of(data: bytes) -> Optional[dict]:
    """Peek a payload's span-propagation context (v2 header field) without
    decoding its buffers; None when the sender attached no trace."""
    header, _ = _read_header(data)
    return header.get("trace")


def loads(data: bytes) -> Any:
    """Decode a wire payload produced by ``dumps`` (either package's).

    Arrays come back as fresh writable host ``np.ndarray``s with the exact
    dtype, shape, and bytes they were encoded with."""
    header, off = _read_header(data)
    bufs: List[np.ndarray] = []
    for spec in header["bufs"]:
        dtype = np.dtype(spec["d"])
        shape = tuple(spec["s"])
        n_elem = int(np.prod(shape, dtype=np.int64))
        nbytes = dtype.itemsize * n_elem
        if off + nbytes > len(data):
            raise WireError("truncated wire payload (buffers)")
        arr = (np.frombuffer(data, dtype=dtype, count=n_elem, offset=off)
               .reshape(shape).copy())
        bufs.append(arr)
        off += nbytes
    return _dec(header["obj"], bufs)
