"""Device meshes, after the JAX package's ``launch/mesh.py``: functions on
``torch.distributed.device_mesh.init_device_mesh``, with the reference's
axis names.  Importing this module touches no process group.

A mesh needs the default process group to be up with as many ranks as the
mesh has devices: on the card, NCCL (``init_process_group("nccl",
init_method="tcp://localhost:<port>", rank=, world_size=)``); on the CPU,
gloo ranks, or the fake process group (``FakeStore``, backend ``"fake"``)
that builds a 512-rank mesh in one process for the sharding rules.

``fake_mesh`` builds a CUDA mesh of any shape on the fake process group
without a card (the reference builds its production meshes on 512 host
placeholder devices, ``dryrun.py:1-5``): the process stands for rank 0 and
every collective does nothing.  It is for the dry-run, which traces on fake
tensors and computes nothing on any device; ``make_mesh`` and
``make_production_mesh`` still need a card unless the CPU is asked for.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_mesh", "production_shape", "fake_mesh"]


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the single-pod or multi-pod production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> DeviceMesh:
    """Single pod: (16, 16) (data, model) = 256 devices.
    Multi-pod: (2, 16, 16) (pod, data, model) = 512 devices; ``pod`` is an
    outer data axis."""
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, *, device: DeviceLike = None) -> DeviceMesh:
    """Any mesh of the default process group's ranks (tests, smoke runs);
    ``device`` as the entry points take it (None: the card)."""
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def fake_mesh(shape, axes, device_type: str = "cuda") -> Iterator[DeviceMesh]:
    """A ``device_type`` mesh of ``shape`` on a fake process group of
    ``prod(shape)`` ranks started here and destroyed on exit.  No card is
    needed and nothing is communicated: trace on it under a
    ``FakeTensorMode``.  Raises if a process group is already up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore   # registers "fake"
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
    try:
        yield init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()
