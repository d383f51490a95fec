"""Production mesh construction; port of ``src/repro/launch/mesh.py``.

A mesh here is a ``sharding.MeshShape``: axis names and sizes, no devices.
The production meshes (256 and 512 ranks) exist as shapes on any machine,
so the dry-run and the sharding rules use them without the devices the
reference forces into being.
"""
from __future__ import annotations

import torch.distributed as dist

from ..sharding.annotate import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model")."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh() -> MeshShape:
    """The process group's ranks as a data mesh: (world, 1) ("data",
    "model"), where world is 1 without a process group."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return MeshShape(("data", "model"), (world, 1))


__all__ = ["make_production_mesh", "make_host_mesh"]
