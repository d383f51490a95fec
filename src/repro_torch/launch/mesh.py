"""Production and device mesh construction; port of
``src/repro/launch/mesh.py``.

``make_production_mesh`` gives a ``sharding.MeshShape``: axis names and
sizes, no devices. The production meshes (256 and 512 ranks) exist as
shapes on any machine, so the dry-run and the sharding rules use them
without the devices the reference forces into being. A mesh of devices is
a ``torch.distributed`` ``DeviceMesh`` over the ranks of the process group
(one process a card): ``make_device_mesh``, ``make_host_mesh`` under an
initialised process group, and ``make_production_device_mesh``, which
raises where the world is smaller than the mesh, as the reference's
``make_production_mesh`` does.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..sharding.annotate import MeshShape
from ..utils.device import resolve_device


def make_device_mesh(sizes, names=("data", "model"),
                     device_type: str | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``sizes`` named ``names`` over the process
    group's ranks (their product must be the world size). ``device_type``
    None is ``"cuda"``, which raises without a GPU (``resolve_device``);
    ``"cpu"`` with a gloo group runs it on the host."""
    dev = resolve_device(device_type)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a device mesh needs an initialised process "
                           "group (torch.distributed.init_process_group or "
                           "torchrun)")
    sizes, names = tuple(int(s) for s in sizes), tuple(names)
    if math.prod(sizes) != dist.get_world_size():
        raise ValueError(f"mesh {sizes} needs {math.prod(sizes)} ranks; the "
                         f"world has {dist.get_world_size()}")
    return init_device_mesh(dev.type, sizes, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model")."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_device_mesh(*, multi_pod: bool = False,
                                device_type: str | None = None
                                ) -> DeviceMesh:
    """The production mesh over the process group's ranks; raises unless
    the world has exactly its 256 (512) ranks."""
    shape = make_production_mesh(multi_pod=multi_pod)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world != shape.size:
        raise RuntimeError(f"mesh {shape.sizes} needs {shape.size} ranks but "
                           f"only {world} exist: launch one process a card "
                           f"over {shape.size} cards")
    return make_device_mesh(shape.sizes, shape.axis_names, device_type)


def make_host_mesh(device_type: str | None = None):
    """The process group's ranks as a data mesh: a ``DeviceMesh`` of
    (world, 1) ("data", "model") under an initialised process group, else
    the ``MeshShape`` (1, 1) of the one device."""
    if dist.is_available() and dist.is_initialized():
        return make_device_mesh((dist.get_world_size(), 1),
                                device_type=device_type)
    return MeshShape(("data", "model"), (1, 1))


__all__ = ["make_device_mesh", "make_production_mesh",
           "make_production_device_mesh", "make_host_mesh"]
