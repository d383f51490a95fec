# Port of src/repro/ckpt/checkpoint.py: the same layout, API and
# fault-tolerance rules over the port's training state.
"""Checkpointing: atomic, sharded, resumable.

Layout:  <dir>/step_<k>/
             manifest.json        tree structure + array metadata
             shard_<i>.npz        array payloads (chunked ~512 MB)
         <dir>/LATEST             committed step pointer (atomic rename)

Fault-tolerance properties:
* **atomic commit** — payloads are written into a temp dir, fsync'd, then
  renamed; LATEST is updated last, so a crash mid-save never corrupts the
  restore point.
* **integrity** — every shard's sha256 is in the manifest and is checked
  before a restore reads it; a corrupt step is skipped for the next-newest.
* **retention** — only the ``keep_last`` newest checkpoints are kept, and
  older ones are deleted only after the new commit succeeds.

A tree is the port's training state: nested dicts (and lists or tuples)
whose leaves are tensors, Python ints or floats. It is flattened by
``flatten_tree`` — dict keys in sorted order, depth first — into leaves and
a structure string that the manifest keeps and a restore compares. Tensors
are stored on the host; bfloat16 and float8 as raw ``uint16``/``uint8``
views (npz has no such dtypes) with the true dtype in the manifest.
``restore_checkpoint`` copies every tensor leaf in place into the matching
tensor of ``tree_like``, on that tensor's device and in its dtype, so the
``nn.Parameter`` objects a model and its optimizer hold stay the same
objects.

Checkpoints are mesh-agnostic, as the reference's (arrays are stored
unsharded): under a ``DeviceMesh`` the ranks gather one DTensor leaf at a
time (``sharding.spmd.full_value``, collectives), rank 0 moves it to the
host and streams it into the same files as on one device (the others drop
it at once), and every rank waits at a barrier until they are committed.
A restore reads the whole files on every rank's host and places each leaf
by ``shardings`` (a tree of ``sharding.NamedSharding`` shaped like the
tree, ``None`` at a host leaf) or, without them, in the layout of
``tree_like``'s leaf; each rank cuts its own shard on the host and moves
only that, so a checkpoint saved on one device restores onto a mesh and
back (the elastic path).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..faults.harness import CheckpointCorruptError, file_digest
from ..obs.log import get_logger
from ..obs.trace import span as _span
from ..sharding.spmd import full_value, place
from ..utils.version import check_version_stamp, version_stamp

_LOG = get_logger("ckpt")

_SHARD_BYTES = 512 * 1024 * 1024

# torch dtypes npz cannot hold, stored as raw unsigned views of their bits:
# dtype -> (torch view, numpy view of the same width, numpy stored dtype)
_RAW_VIEW = {torch.bfloat16: (torch.int16, np.int16, np.uint16)}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _RAW_VIEW[getattr(torch, _name)] = (torch.int8, np.int8, np.uint8)
_DTYPE_BY_NAME = {str(d).removeprefix("torch."): d for d in (
    torch.float64, torch.float32, torch.float16, torch.int64, torch.int32,
    torch.int16, torch.int8, torch.uint8, torch.bool, *_RAW_VIEW)}


def flatten_tree(tree) -> tuple[list, str]:
    """(leaves, structure) of a nested dict/list/tuple tree: dict keys in
    sorted order, depth first. Leaves are tensors, ints or floats; the
    structure names every key and each leaf's kind (T tensor, I int, F
    float), so two trees flatten alike only if they have the same shape."""
    leaves: list = []

    def walk(node) -> str:
        if isinstance(node, dict):
            keys = sorted(node)
            if not all(isinstance(k, str) for k in keys):
                raise TypeError(f"checkpoint tree keys must be str: {keys}")
            return "{" + ",".join(f"{json.dumps(k)}:{walk(node[k])}"
                                  for k in keys) + "}"
        if isinstance(node, (list, tuple)):
            open_, close = ("[", "]") if isinstance(node, list) else ("(", ")")
            return open_ + ",".join(walk(x) for x in node) + close
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return "T"
        if isinstance(node, (bool, np.bool_)):
            raise TypeError("bool leaves are not supported; use an int")
        if isinstance(node, (int, np.integer)):
            leaves.append(int(node))
            return "I"
        if isinstance(node, (float, np.floating)):
            leaves.append(float(node))
            return "F"
        raise TypeError(f"unsupported checkpoint leaf {type(node).__name__}")

    return leaves, walk(tree)


def unflatten_tree(tree_like, leaves: list):
    """``tree_like``'s structure with its leaves replaced by ``leaves`` (in
    ``flatten_tree``'s order). Dicts keep ``tree_like``'s key order: the
    train step sums the gradient norm in that order."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            vals = {k: walk(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        return next(it)

    return walk(tree_like)


def _encode(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int64), "int"
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float64), "float"
    t = leaf.detach()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype in _RAW_VIEW:
        view, _, stored = _RAW_VIEW[t.dtype]
        return t.view(view).cpu().numpy().view(stored), name
    return t.cpu().numpy(), name


def _decode(arr: np.ndarray, dtype_name: str):
    if dtype_name == "int":
        return int(arr)
    if dtype_name == "float":
        return float(arr)
    dtype = _DTYPE_BY_NAME[dtype_name]
    if dtype in _RAW_VIEW:
        _, np_view, _ = _RAW_VIEW[dtype]
        return torch.from_numpy(arr.view(np_view)).view(dtype)
    return torch.from_numpy(arr)


def _fsync(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _meshed(leaves) -> bool:
    return any(isinstance(x, DTensor) for x in leaves)


def save_checkpoint(directory: str, step: int, tree, keep_last: int = 3,
                    config_hash: str | None = None) -> str:
    """Write ``tree`` as step ``step`` under ``directory``; returns the
    step's directory. A tree with DTensor leaves is saved by every rank of
    its mesh together: each leaf is gathered, rank 0 writes, and all return
    once the step is committed."""
    with _span("ckpt.save", step=step):
        leaves, structure = flatten_tree(tree)
        if not _meshed(leaves):
            return _save_checkpoint(directory, step, leaves, structure,
                                    keep_last, config_hash)
        writer = dist.get_rank() == 0

        def gathered():
            # one leaf at a time: gathered on every rank (a collective),
            # kept on rank 0's host only
            for x in leaves:
                if isinstance(x, DTensor):
                    x = full_value(x)
                    x = x.cpu() if writer else None
                yield x

        final = os.path.join(directory, f"step_{step}")
        if writer:
            _save_checkpoint(directory, step, gathered(), structure,
                             keep_last, config_hash)
        else:
            for _ in gathered():
                pass
        dist.barrier()
        return final


def _save_checkpoint(directory, step, leaves, structure, keep_last,
                     config_hash) -> str:
    """Write ``leaves`` (``flatten_tree``'s order; any iterable, consumed
    once, so a meshed save streams them) under ``structure``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "treedef": structure,
                "n_leaves": 0, "shards": [], "dtypes": {},
                "versions": version_stamp(config_hash)}
    shard, shard_bytes, shard_idx = {}, 0, 0

    def flush():
        nonlocal shard, shard_bytes, shard_idx
        if not shard:
            return
        path = os.path.join(tmp, f"shard_{shard_idx}.npz")
        np.savez(path, **shard)
        _fsync(path)
        manifest["shards"].append(
            {"file": f"shard_{shard_idx}.npz", "keys": sorted(shard),
             "sha256": file_digest(path)})
        shard, shard_bytes = {}, 0
        shard_idx += 1

    for i, leaf in enumerate(leaves):
        arr, dtype_name = _encode(leaf)
        manifest["dtypes"][f"leaf_{i}"] = dtype_name
        shard[f"leaf_{i}"] = arr
        shard_bytes += arr.nbytes
        manifest["n_leaves"] = i + 1
        if shard_bytes >= _SHARD_BYTES:
            flush()
    flush()

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest = os.path.join(directory, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest + ".tmp", latest)

    # retention: GC old steps only after the commit
    steps = sorted(_list_steps(directory))
    for old in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{old}"),
                      ignore_errors=True)
    return final


def _list_steps(directory: str) -> list[int]:
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> int | None:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        step = int(f.read().strip())
    if os.path.isdir(os.path.join(directory, f"step_{step}")):
        return step
    # LATEST points at a GC'd/corrupt dir: fall back to newest on disk
    steps = _list_steps(directory)
    return max(steps) if steps else None


def _restore_step(directory, step, tree_like, shardings, config_hash):
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    for problem in check_version_stamp(manifest.get("versions"),
                                       config_hash=config_hash,
                                       what=f"checkpoint step_{step}"):
        _LOG.warning(f"[ckpt] restore warning: {problem}")
    leaves, structure = flatten_tree(tree_like)
    places = _sharding_leaves(tree_like, shardings, len(leaves))
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves)} (architecture mismatch?)")
    if manifest["treedef"] != structure:
        raise ValueError("checkpoint tree structure differs from the "
                         "tree to restore into (architecture mismatch?)")
    # every shard is verified before any leaf is touched, so a corrupt
    # step leaves tree_like as it was
    for sh in manifest["shards"]:
        path = os.path.join(d, sh["file"])
        if file_digest(path) != sh["sha256"]:
            raise CheckpointCorruptError(
                f"{path}: sha256 mismatch (torn or bit-rotted shard)")
    data: dict[str, object] = {}
    for sh in manifest["shards"]:
        with np.load(os.path.join(d, sh["file"])) as z:
            for k in sh["keys"]:
                data[k] = _decode(z[k], manifest["dtypes"][k])
    for i, ref in enumerate(leaves):
        got = data[f"leaf_{i}"]
        if isinstance(ref, torch.Tensor) != isinstance(got, torch.Tensor):
            raise ValueError(f"leaf {i}: kind differs from the checkpoint")
        if isinstance(ref, torch.Tensor) and tuple(got.shape) != \
                tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    new_leaves = []
    with torch.no_grad():
        for i, ref in enumerate(leaves):
            got = data.pop(f"leaf_{i}")
            if not isinstance(ref, torch.Tensor):
                new_leaves.append(type(ref)(got))
                continue
            sh = places[i]
            if sh is None and isinstance(ref, DTensor):
                sh = _Like(ref)
            if sh is None:
                ref.copy_(got)
                new_leaves.append(ref)
                continue
            got = place(got.to(dtype=ref.dtype), sh)
            if isinstance(ref, DTensor) and \
                    tuple(ref.placements) == tuple(got.placements):
                ref.to_local().copy_(got.to_local())
                new_leaves.append(ref)
            else:
                new_leaves.append(got)
    return unflatten_tree(tree_like, new_leaves), step


class _Like:
    """The layout of a DTensor, as a ``NamedSharding`` is one."""

    def __init__(self, ref: DTensor):
        self.mesh, self.placements = ref.device_mesh, ref.placements


def _sharding_leaves(tree_like, shardings, n: int) -> list:
    """One sharding (or None) per leaf of ``tree_like``, in
    ``flatten_tree``'s order."""
    if shardings is None:
        return [None] * n
    out: list = []

    def walk(node, sh):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], None if sh is None else sh[k])
        elif isinstance(node, (list, tuple)):
            for i, x in enumerate(node):
                walk(x, None if sh is None else sh[i])
        else:
            out.append(sh)

    walk(tree_like, shardings)
    return out


def restore_checkpoint(directory: str, tree_like, step: int | None = None,
                       shardings=None, config_hash: str | None = None):
    """Restore into the structure of ``tree_like``: each tensor leaf is
    copied in place into ``tree_like``'s tensor (its device, its dtype);
    int and float leaves come back in the returned tree. Returns (tree,
    step). ``shardings`` (a tree of ``NamedSharding`` like
    ``train.state.train_state_shardings`` gives, ``None`` at host leaves)
    places each restored tensor on its mesh; a leaf of ``tree_like`` in
    that layout keeps its object, any other is replaced by the placed
    DTensor. A repro/torch/config-hash mismatch against the manifest's
    version stamp warns rather than failing.

    Shard payloads are verified against the manifest's per-shard sha256
    before deserialization. With ``step=None`` a corrupt or unreadable
    step warns and falls back to the next-newest step on disk; an explicit
    ``step`` raises ``CheckpointCorruptError`` instead."""
    with _span("ckpt.restore", step=step):
        return _restore_checkpoint(directory, tree_like, step, shardings,
                                   config_hash)


def _restore_checkpoint(directory, tree_like, step, shardings, config_hash):
    import zipfile

    if step is not None:
        return _restore_step(directory, step, tree_like, shardings,
                             config_hash)
    preferred = latest_step(directory)
    steps = sorted(_list_steps(directory), reverse=True) \
        if os.path.isdir(directory) else []
    if preferred in steps:
        steps.remove(preferred)
        steps.insert(0, preferred)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    last_err = None
    for s in steps:
        try:
            return _restore_step(directory, s, tree_like, shardings,
                                 config_hash)
        except (CheckpointCorruptError, OSError, KeyError, EOFError,
                json.JSONDecodeError, zipfile.BadZipFile) as e:
            _LOG.warning(f"[ckpt] step_{s} rejected ({type(e).__name__}: "
                         f"{e}); falling back to an older step")
            last_err = e
    raise CheckpointCorruptError(
        f"no restorable checkpoint under {directory}") from last_err


class CheckpointManager:
    """Convenience wrapper: periodic save + resume + preemption save."""

    def __init__(self, directory: str, interval: int = 100,
                 keep_last: int = 3, config_hash: str | None = None):
        self.directory = directory
        self.interval = interval
        self.keep_last = keep_last
        self.config_hash = config_hash

    def maybe_save(self, step: int, tree, force: bool = False):
        if force or (step > 0 and step % self.interval == 0):
            return save_checkpoint(self.directory, step, tree,
                                   self.keep_last,
                                   config_hash=self.config_hash)
        return None

    def restore_or_init(self, tree_like, shardings=None):
        try:
            return restore_checkpoint(self.directory, tree_like,
                                      shardings=shardings,
                                      config_hash=self.config_hash)
        except FileNotFoundError:
            return tree_like, -1


__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager", "flatten_tree", "unflatten_tree"]
