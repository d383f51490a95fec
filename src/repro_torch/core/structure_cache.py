# Copy of src/repro/core/structure_cache.py, kept so repro_torch never imports repro.
"""Process-wide cache of per-structure sweep artifacts.

Sweep points that share (topology, n, routing, seed, packaging, technology)
and differ only in the traffic pattern need the *same* graph, routing table,
step costs, and routed diameter. Building those is the expensive host-side
part of sweep preparation (graph construction + routing-table relaxation), so
we build each unique structure once and reuse it:

* ``dse.batch.encode_designs`` groups design points by
  ``DesignPoint.structure_key()`` and hits this cache per group;
* ``core.ici_model.estimate_collective`` keys the 256-chip pod design here
  instead of rebuilding it on every collective estimate.

Entries are immutable by convention: consumers must treat the stored arrays
as read-only (they are shared across threads — the DSE engine encodes the
next chunk on a worker thread while the device evaluates the current one).
The cache is a bounded LRU guarded by a lock, so concurrent encode/evaluate
threads are safe.
"""
from __future__ import annotations

import pickle
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable

from ..obs import metrics as _metrics

# Process-wide telemetry series (repro.obs): unlike the per-instance
# hits/misses attributes these survive cache clears, so a run report shows
# cumulative cache behaviour even across benchmark phases.
_HIT_COUNTER = _metrics.counter("structure_cache.hit")
_MISS_COUNTER = _metrics.counter("structure_cache.miss")
_EVICT_COUNTER = _metrics.counter("structure_cache.evict")


@dataclass
class StructureEntry:
    """Everything reusable across traffic patterns for one design structure."""
    arrays: Any                # core.proxies.DeviceArrays (read-only)
    graph: Any = None          # core.graph.DenseGraph, if the builder kept it
    diameter: int | None = None   # routed diameter; filled lazily (batched)
    extra: dict = field(default_factory=dict)


def _entry_nbytes(entry: StructureEntry) -> int:
    """Approximate host-memory footprint of one entry: dense arrays plus any
    non-trivial objects retained in ``extra`` (e.g. the built Design kept for
    the optimizer's report masks) so the byte-budgeted eviction sees them."""
    total = 0
    for obj in (entry.arrays, entry.graph):
        if obj is None:
            continue
        for v in vars(obj).values():
            total += getattr(v, "nbytes", 0)
    for v in entry.extra.values():
        nb = getattr(v, "nbytes", None)
        if nb is not None:
            total += int(nb)
        elif not isinstance(v, (bool, int, float, str, bytes, type(None))):
            try:
                total += len(pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL))
            except Exception:
                pass
    return total


class StructureCache:
    """Bounded, thread-safe LRU keyed by an opaque hashable structure key.

    Eviction is budgeted in *bytes* as well as entries: large-n sweeps carry
    multi-MB dense arrays per structure, so an entry-count bound alone could
    pin gigabytes of host memory."""

    def __init__(self, maxsize: int = 4096, max_bytes: int = 512 * 2**20):
        self.maxsize = maxsize
        self.max_bytes = max_bytes
        self._entries: OrderedDict[Hashable, StructureEntry] = OrderedDict()
        self._nbytes: dict[Hashable, int] = {}
        self._total_bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable) -> StructureEntry | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                _MISS_COUNTER.inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            _HIT_COUNTER.inc()
            return entry

    def put(self, key: Hashable, entry: StructureEntry) -> StructureEntry:
        nbytes = _entry_nbytes(entry)
        with self._lock:
            if key in self._entries:
                self._total_bytes -= self._nbytes.get(key, 0)
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self._nbytes[key] = nbytes
            self._total_bytes += nbytes
            while self._entries and (len(self._entries) > self.maxsize or
                                     self._total_bytes > self.max_bytes):
                old_key, _ = self._entries.popitem(last=False)
                self._total_bytes -= self._nbytes.pop(old_key, 0)
                _EVICT_COUNTER.inc()
        return entry

    def get_or_build(self, key: Hashable,
                     builder: Callable[[], StructureEntry]) -> StructureEntry:
        entry = self.get(key)
        if entry is None:
            # The builder runs outside the lock (it may be seconds of host
            # work); a concurrent builder for the same key just overwrites
            # with an equivalent entry.
            entry = self.put(key, builder())
        return entry

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._nbytes.clear()
            self._total_bytes = 0
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {"size": len(self._entries), "bytes": self._total_bytes,
                    "hits": self.hits, "misses": self.misses,
                    "maxsize": self.maxsize, "max_bytes": self.max_bytes}


# The default process-wide cache shared by the DSE encoder and the ICI model.
GLOBAL_STRUCTURE_CACHE = StructureCache()
