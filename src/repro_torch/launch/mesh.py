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

``counting_world`` is the dry-run's stand-in for the production world: a
process group of PyTorch's "fake" backend, as large as the mesh, in which
this one process is one rank. Its collectives send nothing and return at
once, so the rank's own program (``sharding.spmd``) runs on meta shards
and can be counted, op by op and collective by collective.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
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


@contextlib.contextmanager
def counting_world(shape: MeshShape, rank: int = 0):
    """Rank ``rank`` of a world of ``shape.size`` ranks that only counts:
    a process group of the "fake" backend (no communication; every
    collective returns at once), the ``DeviceMesh`` of ``shape`` over it
    with device type "cpu" (DTensor's sharding propagation asks a meta
    mesh for a device count), on which ``sharding.spmd`` keeps every shard
    on the meta device. Yields the mesh; the group is destroyed on exit.
    Raises where a process group exists already: one process holds one
    default group, and a real rank's group must not be replaced."""
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError("a counting world needs a process without a "
                           "process group; this one has "
                           f"{dist.get_world_size()} ranks already")
    if not 0 <= rank < shape.size:
        raise ValueError(f"rank {rank} of a world of {shape.size}")
    # registers the "fake" backend (torch._C._distributed_c10d's
    # FakeProcessGroup) under that name in every release that has it
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    _forget_meshes()
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=shape.size)
    try:
        yield init_device_mesh("cpu", shape.sizes,
                               mesh_dim_names=shape.axis_names)
    finally:
        dist.destroy_process_group()
        _forget_meshes()


def _forget_meshes() -> None:
    """Empty DTensor's sharding-propagation caches: a cached layout holds
    its mesh, and another world's mesh of the same shape compares equal to
    it, so a DTensor op there would come back on the groups of a world
    that is gone."""
    prop = DTensor._op_dispatcher.sharding_propagator
    for name in dir(prop):
        clear = getattr(getattr(prop, name, None), "cache_clear", None)
        if callable(clear):
            clear()
    # the C++ dispatch's own cache, in the releases that have one
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()


__all__ = ["make_device_mesh", "make_production_mesh",
           "make_production_device_mesh", "make_host_mesh",
           "counting_world"]
