"""Device meshes, after the JAX package's ``launch/mesh.py``: functions on
``torch.distributed.device_mesh.init_device_mesh``, with the reference's
axis names.  Importing this module touches no process group.

A mesh needs the default process group to be up with as many ranks as the
mesh has devices: on the card, NCCL (``init_process_group("nccl",
init_method="tcp://localhost:<port>", rank=, world_size=)``); on the CPU,
gloo ranks, or the fake process group (``FakeStore``, backend ``"fake"``)
that builds a 512-rank mesh in one process for the sharding rules.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> DeviceMesh:
    """Single pod: (16, 16) (data, model) = 256 devices.
    Multi-pod: (2, 16, 16) (pod, data, model) = 512 devices; ``pod`` is an
    outer data axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape, axes, *, device: DeviceLike = None) -> DeviceMesh:
    """Any mesh of the default process group's ranks (tests, smoke runs);
    ``device`` as the entry points take it (None: the card)."""
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))
