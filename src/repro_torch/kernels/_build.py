"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) into a shared
library of its own with a plain C interface, one ``nvcc`` process per source,
all started together; ``ctypes`` loads them.  Nothing includes PyTorch's
headers, so a build takes seconds.  Nothing is linked beyond the CUDA
runtime either: the one libcuda function a kernel needs (the TMA
descriptor's ``cuTensorMapEncodeTiled``) is fetched at run time through the
runtime's entry-point query.  Headers shared by the sources
(``csrc/*.cuh``) are part of every source's hash.

The build happens at the first kernel launch, into
``build/repro_torch_kernels/<hash of the sources>/`` at the repository root,
so an edited source is rebuilt and a stale library is never loaded.  A failed
build raises with the compiler's output; so does a launch that returns a CUDA
error (``check``).  Every source compiled is counted in ``obs/torchprof``
(``torch_kernel_builds_total``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import types
from pathlib import Path
from typing import Optional

import torch

from ..obs import torchprof

__all__ = ["BUILD_DIR", "CSRC", "build", "check", "library", "stream"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_C_PTR = ctypes.c_void_p
_C_INT = ctypes.c_int
_C_I64 = ctypes.c_longlong
_C_FLOAT = ctypes.c_float
# C signature of each source's launcher ``launch_<source stem>``: pointer,
# int and float arguments, then the stream
_SIGNATURES = {
    "masked_histogram":
        [_C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT,
         _C_PTR],
    "fused_delta_fitness":
        [_C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR,
         _C_INT, _C_INT, _C_INT, _C_INT, _C_PTR],
    "flash_attention":
        [_C_PTR, _C_PTR, _C_PTR, _C_PTR,
         _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_FLOAT, _C_PTR],
    "ssd_scan":
        [_C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR, _C_PTR,
         _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT, _C_INT,
         _C_I64, _C_I64, _C_I64, _C_I64, _C_PTR, _C_INT, _C_PTR],
}

_lib: Optional[types.SimpleNamespace] = None
build_log = ""   # the compiler's output of the last build (registers, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> list[Path]:
    """Compile every source into its own library (one nvcc each, in parallel).

    Returns the libraries' paths; libraries built from the same sources are
    reused."""
    global build_log
    sources = _sources()
    out_dir = BUILD_DIR / _digest(sources)
    libs = [out_dir / f"lib{src.stem}.so" for src in sources]
    if all(lib.exists() for lib in libs):
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmps = [lib.with_suffix(f".{os.getpid()}.tmp") for lib in libs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, str(src), "-o", str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, tmp in zip(sources, tmps)]
    logs = [f"== {src.name}\n{proc.communicate()[0]}" for src, proc in zip(sources, procs)]
    build_log = "\n".join(logs)
    failed = [src.name for src, proc in zip(sources, procs) if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{build_log}")
    for tmp, lib in zip(tmps, libs):
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    for src in sources:
        torchprof.note_trace(src.stem)
    return libs


def library() -> types.SimpleNamespace:
    """The kernels' C launchers, ``launch_<source stem>``, built at first use."""
    global _lib
    if _lib is None:
        launchers = {}
        for path in build():
            stem = path.stem[len("lib"):]
            fn = getattr(ctypes.CDLL(str(path)), f"launch_{stem}")
            fn.argtypes = _SIGNATURES[stem]
            fn.restype = ctypes.c_int
            launchers[f"launch_{stem}"] = fn
        _lib = types.SimpleNamespace(**launchers)
    return _lib


# the current stream's raw handle without building a ``torch.cuda.Stream``
# (the private call inductor's generated code uses), else the public one
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream(device_index: int) -> int:
    """The current CUDA stream of device ``device_index``, as an int handle."""
    if _raw_stream is not None:
        return _raw_stream(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with cudaError_t {err}")
