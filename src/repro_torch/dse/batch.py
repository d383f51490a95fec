"""Padded dense batch encoding of design points; port of
``src/repro/dse/batch.py``.

All designs in one batch are padded to the same node count, so the batched
proxies run as one fixed-shape batch. The host work (graph, routing table,
step costs) is numpy and cache-aware, as in the reference:

* points are grouped by ``DesignPoint.structure_key()`` — the sweep points
  that differ only in traffic pattern build their structure **once**
  (``core.structure_cache``);
* the routed diameter of every newly built structure comes from **one**
  batched call on the stacked next-hop tensor, on the batch's device.

The finished batch holds tensors on that device (None -> cuda).

Padding semantics:
  next_hop    : padded vertices route to themselves (= unreachable; proxies
                mask them out because padded traffic is zero)
  step_cost   : 0 (never gathered for real routes)
  adj_bw      : 0 on non-edges; bandwidth min() masks zero-flow edges
  traffic     : 0 rows/cols for padded chiplets
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.proxies import prepare_arrays
from ..core.structure_cache import (
    GLOBAL_STRUCTURE_CACHE, StructureCache, StructureEntry,
)
from ..utils.device import resolve_device
from .sweep import DesignPoint


@dataclass
class DesignBatch:
    next_hop: torch.Tensor     # int32 [B, n, n]
    step_cost: torch.Tensor    # f32  [B, n, n]
    node_weight: torch.Tensor  # f32  [B, n]
    adj_bw: torch.Tensor       # f32  [B, n, n]
    traffic: torch.Tensor      # f32  [B, n, n]  (padded to n, not n_chiplets)
    max_hops: int              # static routed-diameter bound over the batch
    points: list               # the DesignPoints, batch order

    @property
    def size(self) -> int:
        return self.next_hop.shape[0]

    @property
    def n(self) -> int:
        return self.next_hop.shape[1]

    def to(self, device) -> "DesignBatch":
        """The same batch with every tensor on ``device``."""
        return DesignBatch(
            next_hop=self.next_hop.to(device),
            step_cost=self.step_cost.to(device),
            node_weight=self.node_weight.to(device),
            adj_bw=self.adj_bw.to(device), traffic=self.traffic.to(device),
            max_hops=self.max_hops, points=self.points)


def batch_from_numpy(next_hop, step_cost, node_weight, adj_bw, traffic,
                     max_hops: int, points=None, device=None) -> DesignBatch:
    """The port's batch from the numpy arrays of an encoded batch (e.g. the
    fields of ``repro.dse.DesignBatch``), so one encoding can feed both
    evaluators. ``device`` None -> cuda."""
    dev = resolve_device(device)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=dtype),
                               device=dev)

    return DesignBatch(
        next_hop=put(next_hop, np.int32), step_cost=put(step_cost, np.float32),
        node_weight=put(node_weight, np.float32),
        adj_bw=put(adj_bw, np.float32), traffic=put(traffic, np.float32),
        max_hops=int(max_hops), points=list(points or []))


def _structures_for(points: list[DesignPoint], validate: bool,
                    cache: StructureCache | None,
                    keep_designs: bool = False) -> dict:
    """Map structure_key -> StructureEntry, building each unique structure
    once (through the cache when one is given).

    ``keep_designs`` retains the built ``Design`` in ``entry.extra``."""
    from ..core.design import validate_design

    entries: dict = {}
    for pt in points:
        key = pt.structure_key()
        if key in entries:
            continue
        entry = cache.get(key) if cache is not None else None
        if entry is None:
            # The graph is not retained: cached entries keep only the dense
            # arrays (+ diameter) so the cache stays small.
            design = pt.build()
            arrays, _ = prepare_arrays(design, validate=validate)
            entry = StructureEntry(arrays=arrays,
                                   extra={"validated": validate})
            if keep_designs:
                entry.extra["design"] = design
            if cache is not None:
                cache.put(key, entry)
        else:
            design = entry.extra.get("design")
            if validate and not entry.extra.get("validated"):
                # Entry was cached by a validate=False caller; a
                # validate=True request must still see validation errors.
                design = design if design is not None else pt.build()
                validate_design(design)
                entry.extra["validated"] = True
            if keep_designs and "design" not in entry.extra:
                entry.extra["design"] = (design if design is not None
                                         else pt.build())
                if cache is not None:
                    # re-account: the retained Design changed the entry size
                    cache.put(key, entry)
        entries[key] = entry
    return entries


def _fill_diameters(entries: dict, n: int, device: torch.device) -> None:
    """Batched routed diameter for every entry that does not have one yet:
    stack the (padded) next-hop tables and run one call on ``device``."""
    from ..core.latency import routed_diameter_batch

    missing = [e for e in entries.values() if e.diameter is None]
    if not missing:
        return
    stacked = np.tile(np.arange(n, dtype=np.int32)[None, :, None],
                      (len(missing), 1, n))
    for i, e in enumerate(missing):
        k = e.arrays.next_hop.shape[0]
        stacked[i, :k, :k] = e.arrays.next_hop
    for e, dia in zip(missing, routed_diameter_batch(stacked, device)):
        e.diameter = int(dia)


def encode_designs(points: list[DesignPoint], n_pad: int | None = None,
                   validate: bool = True,
                   cache: StructureCache | None = GLOBAL_STRUCTURE_CACHE,
                   keep_designs: bool = False,
                   device=None) -> DesignBatch:
    """Build + encode every design point into one padded batch on
    ``device`` (None -> cuda).

    ``cache=None`` disables structure reuse across calls (each call still
    builds every unique structure within the batch only once).
    """
    dev = resolve_device(device)
    entries = _structures_for(points, validate, cache, keep_designs)

    n_max = max(e.arrays.next_hop.shape[0] for e in entries.values())
    n = n_pad or n_max
    if n < n_max:
        raise ValueError(f"n_pad={n} smaller than largest design ({n_max})")
    _fill_diameters(entries, n, dev)
    B = len(points)

    # nh[b, u, d] = u  (padded vertices route to themselves = unreachable)
    next_hop = np.tile(np.arange(n, dtype=np.int32)[None, :, None], (B, 1, n))
    step_cost = np.zeros((B, n, n), np.float32)
    node_weight = np.zeros((B, n), np.float32)
    adj_bw = np.zeros((B, n, n), np.float32)
    traffic = np.zeros((B, n, n), np.float32)
    max_hops = 1
    for b, pt in enumerate(points):
        entry = entries[pt.structure_key()]
        arrays = entry.arrays
        k = arrays.next_hop.shape[0]
        nc = arrays.n_chiplets
        next_hop[b, :k, :k] = arrays.next_hop
        step_cost[b, :k, :k] = arrays.step_cost
        node_weight[b, :k] = arrays.node_weight
        adj_bw[b, :k, :k] = arrays.adj_bw
        traffic[b, :nc, :nc] = pt.traffic()
        max_hops = max(max_hops, entry.diameter)

    return batch_from_numpy(next_hop, step_cost, node_weight, adj_bw, traffic,
                            max_hops, points, dev)


__all__ = ["DesignBatch", "batch_from_numpy", "encode_designs"]
