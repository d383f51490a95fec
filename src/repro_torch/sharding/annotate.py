"""Logical-axis sharding annotations (MaxText-style); port of
``src/repro/sharding/annotate.py``.

Model code may tag intermediates with *logical* axis names, and the
launcher binds logical names to physical mesh axes with
``logical_axis_rules``. Rules are (logical_name -> mesh axis | tuple |
None). The resolver skips a physical axis that is absent from the mesh, so
one rule set serves single-pod ("data", "model") and multi-pod ("pod",
"data", "model") meshes.

What a spec and a mesh are here, where the reference has JAX's types:

* ``PartitionSpec`` is a tuple with one entry per dimension: ``None``, a
  mesh axis name, or a tuple of names. ``tuple(spec)`` equals
  ``tuple(jax.sharding.PartitionSpec(...))`` for the same spec.
* A mesh is anything with ``.axis_names`` and ``.shape`` (a name -> size
  mapping): the port's ``MeshShape`` (names and sizes, no devices, so the
  256- and 512-way production meshes exist on one card), or a
  ``torch.distributed`` ``DeviceMesh`` through ``as_mesh_shape``.
* On a ``DeviceMesh`` a spec becomes DTensor placements (``placements``),
  and ``NamedSharding`` pairs the two, as JAX's does: the layout a tensor
  of the meshed train state is placed in.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

from torch.distributed.tensor import Replicate, Shard

_state = threading.local()

# Logical axis vocabulary:
#   batch       activation batch
#   seq         sequence (sequence parallelism for very long contexts)
#   embed       d_model / residual stream
#   heads       attention heads
#   kv_heads    kv heads
#   mlp         feed-forward hidden
#   vocab       vocabulary
#   experts     MoE expert axis
#   ssm_inner   mamba expanded channels
#   fsdp        parameter/optimizer shard axis (maps to data(+pod))
#   stage       pipeline stage (optional pipeline executor)
DEFAULT_RULES: tuple[tuple[str, object], ...] = (
    ("batch", ("pod", "data")),
    ("fsdp", ("pod", "data")),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", "model"),   # fallback when head counts don't divide TP
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    ("ssm_inner", "model"),
    ("embed", None),
    ("seq", None),
)

# Serving: params live in pure-TP layout (replicated across the data axes)
# so decode steps never all-gather weights. The KV cache is batch-sharded
# but model-replicated (kv_heads / head_dim -> None), and decode caches
# shard their sequence dim over the model axis ("seq_kv").
SERVING_RULES: tuple[tuple[str, object], ...] = (
    ("batch", ("pod", "data")),
    ("fsdp", None),
    ("heads", "model"),
    ("kv_heads", None),
    ("head_dim", None),
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    ("ssm_inner", "model"),
    ("embed", None),
    ("seq", None),
    ("seq_kv", "model"),
)

# Long-context serving: batch may be tiny (long_500k has global batch 1), so
# activations shard the sequence instead.
LONG_CONTEXT_RULES: tuple[tuple[str, object], ...] = (
    ("batch", None),
    ("fsdp", ("pod", "data")),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", "model"),
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    ("ssm_inner", "model"),
    ("embed", None),
    ("seq", ("pod", "data")),
)


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), a mesh axis name, or a
    tuple of names (sharded over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class MeshShape:
    """A device mesh by its axis names and sizes only: what sharding rules,
    the dry-run and the collective model need, with no device behind it."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} vs {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def as_mesh_shape(mesh) -> MeshShape:
    """A ``MeshShape`` of a ``MeshShape``, of a ``DeviceMesh`` (its
    ``mesh_dim_names`` and sizes) or of any mesh with ``axis_names`` and a
    name -> size ``shape``."""
    if isinstance(mesh, MeshShape):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshShape(tuple(names), tuple(int(s) for s in mesh.shape))
    shape = mesh.shape
    return MeshShape(tuple(mesh.axis_names),
                     tuple(int(shape[a]) for a in mesh.axis_names))


@contextlib.contextmanager
def logical_axis_rules(mesh, rules=DEFAULT_RULES):
    """Bind ``rules`` to ``mesh`` for this thread."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh():
    ctx = getattr(_state, "ctx", None)
    return ctx[0] if ctx else None


def current_rules() -> dict | None:
    ctx = getattr(_state, "ctx", None)
    return ctx[1] if ctx else None


def resolve_spec(logical: tuple, mesh=None, rules: dict | None = None,
                 dims: tuple | None = None) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec against the mesh (the
    bound one if None).

    ``dims`` (the array shape) enables divisibility pruning: a physical
    mesh axis is only used if it evenly divides the remaining dimension
    size, so e.g. 2 kv-heads on a 16-way "model" axis degrade to
    replicated. A physical axis is used once per spec.
    """
    mesh = mesh if mesh is not None else current_mesh()
    rules = rules or current_rules() or dict(DEFAULT_RULES)
    sizes = as_mesh_shape(mesh).shape if mesh is not None else {}
    out = []
    used: set[str] = set()
    for i, name in enumerate(logical):
        phys = rules.get(name) if name is not None else None
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        dim = dims[i] if dims is not None and i < len(dims) else None
        keep = []
        remaining = dim
        for a in phys:
            if a not in sizes or a in used:
                continue
            if remaining is not None:
                if remaining % sizes[a] != 0:
                    continue
                remaining //= sizes[a]
            keep.append(a)
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return PartitionSpec(*out)


def shard(x, *logical):
    """Tag an intermediate with logical axis names. It returns ``x``
    unchanged, with or without a binding: eager PyTorch has no GSPMD
    partitioner to hand a layout constraint to, so the port's models do not
    call it (the reference's ``with_sharding_constraint``). Under a
    ``DeviceMesh`` the model runs once a rank (``sharding/spmd.py``): an
    activation is the rank's rows, whole over "model" outside the
    context-parallel attention and the scan (ROADMAP Queue C)."""
    return x


def placements(spec, device_mesh) -> list:
    """``spec`` as DTensor placements on ``device_mesh``: a mesh dim that
    entry ``i`` names gets ``Shard(i)``, one that no entry names
    ``Replicate()``. An entry that names several mesh dims (``("pod",
    "data")``) shards its tensor dim over them in mesh order, which is
    DTensor's order; JAX takes the tuple's, so the tuple must be in mesh
    order (every rule set's is)."""
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"order {names}")
        for d in dims:
            out[d] = Shard(i)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` and a spec: the layout of one tensor of the meshed
    train state (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``torch.distributed`` ``DeviceMesh`` (and not
    a ``MeshShape``, which has no devices)."""
    return getattr(mesh, "mesh_dim_names", None) is not None \
        and hasattr(mesh, "get_group")


def spec_ways(spec, mesh) -> int:
    """How many ways ``spec`` divides a tensor on ``mesh``: the product of
    the sizes of the mesh axes it names."""
    sizes = as_mesh_shape(mesh).shape
    ways = 1
    for entry in spec:
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            ways *= sizes[a]
    return ways


__all__ = ["DEFAULT_RULES", "SERVING_RULES", "LONG_CONTEXT_RULES",
           "PartitionSpec", "P", "MeshShape", "as_mesh_shape",
           "logical_axis_rules", "current_mesh", "current_rules",
           "resolve_spec", "shard", "spec_ways", "placements",
           "NamedSharding", "is_device_mesh"]
