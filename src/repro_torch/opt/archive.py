# Copy of src/repro/opt/archive.py, kept so repro_torch never imports repro.
"""Multi-objective Pareto archive for ICI design optimization.

Generalizes the sweep-side ``dse/pareto.py`` front computation (which now
re-exports from here) into a maintained archive the optimizers update every
generation:

* objectives are (minimize latency, maximize throughput) — the paper's two
  proxies;
* constraint masks (area/power/cost budgets from batched ``core/reports.py``)
  filter candidates before they enter;
* the 2-D hypervolume indicator w.r.t. a reference point measures front
  quality, so searches with different budgets are comparable.

Everything is plain numpy: archives hold tens of points, the heavy math is in
the proxy engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def staircase_front(latency: np.ndarray, throughput: np.ndarray,
                    idx: np.ndarray, tol: float = 0.0) -> np.ndarray:
    """The one dominance scan every front computation in this package uses:
    among candidate indices ``idx``, sort by (latency asc, throughput desc —
    stable, so earlier candidates win exact ties) and keep the staircase of
    strictly (by ``tol``) rising throughput. Returned in scan order."""
    lat = np.asarray(latency, np.float64)
    thr = np.asarray(throughput, np.float64)
    order = idx[np.lexsort((-thr[idx], lat[idx]))]
    front = []
    best_thr = -np.inf
    for i in order:
        if thr[i] > best_thr + tol:
            front.append(int(i))
            best_thr = thr[i]
    return np.asarray(front, np.int64)


def pareto_front(latency: np.ndarray, throughput: np.ndarray,
                 mask: np.ndarray | None = None) -> np.ndarray:
    """Indices of the Pareto-optimal points (minimize latency, maximize
    throughput), sorted by latency. ``mask`` filters candidates (e.g. an
    area budget)."""
    idx = np.arange(len(np.asarray(latency, np.float64)))
    if mask is not None:
        idx = idx[np.asarray(mask, bool)]
    return staircase_front(latency, throughput, idx, tol=1e-12)


def hypervolume_2d(latency, throughput,
                   ref_latency: float, ref_throughput: float = 0.0) -> float:
    """2-D hypervolume of the (min-latency, max-throughput) front w.r.t. the
    reference point ``(ref_latency, ref_throughput)``: the area of the
    objective-space region dominated by the front and dominating the
    reference. Points that do not strictly dominate the reference contribute
    nothing; empty input gives 0."""
    lat = np.asarray(latency, np.float64).ravel()
    thr = np.asarray(throughput, np.float64).ravel()
    keep = (np.isfinite(lat) & np.isfinite(thr) &
            (lat < ref_latency) & (thr > ref_throughput))
    if not keep.any():
        return 0.0
    lat, thr = lat[keep], thr[keep]
    front = pareto_front(lat, thr)
    # Front sorted by latency ascending has strictly increasing throughput:
    # each point adds the rectangle up from the previous throughput level.
    hv = 0.0
    prev_thr = ref_throughput
    for i in front:
        hv += (ref_latency - lat[i]) * (thr[i] - prev_thr)
        prev_thr = thr[i]
    return float(hv)


@dataclass
class ArchiveEntry:
    """One non-dominated design kept by the archive."""
    latency: float
    throughput: float
    metrics: dict = field(default_factory=dict)   # area/power/cost, ...
    payload: object = None                        # genome / DesignPoint info

    def to_dict(self) -> dict:
        payload = self.payload
        if isinstance(payload, np.ndarray):
            payload = payload.tolist()
        return {"latency": self.latency, "throughput": self.throughput,
                "metrics": dict(self.metrics), "payload": payload}

    @classmethod
    def from_dict(cls, d: dict) -> "ArchiveEntry":
        return cls(latency=float(d["latency"]),
                   throughput=float(d["throughput"]),
                   metrics=dict(d.get("metrics") or {}),
                   payload=d.get("payload"))


class ParetoArchive:
    """Maintained set of mutually non-dominated (latency, throughput) points.

    ``update`` folds a batch of candidates in: infeasible and non-finite
    candidates are dropped, then the union of archive and candidates is
    reduced to its non-dominated subset (exact duplicates keep the earliest
    entry, so the archive is stable under re-insertion)."""

    def __init__(self):
        self.entries: list[ArchiveEntry] = []

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def latencies(self) -> np.ndarray:
        return np.asarray([e.latency for e in self.entries], np.float64)

    @property
    def throughputs(self) -> np.ndarray:
        return np.asarray([e.throughput for e in self.entries], np.float64)

    def update(self, latency, throughput, feasible=None, payloads=None,
               metrics: dict | None = None) -> int:
        """Insert a candidate batch; returns how many new entries survived.

        ``feasible``: bool mask [B] (constraint budgets); ``payloads``: one
        opaque object per candidate; ``metrics``: dict of [B] arrays attached
        per-entry (e.g. the batched report columns)."""
        lat = np.asarray(latency, np.float64).ravel()
        thr = np.asarray(throughput, np.float64).ravel()
        ok = np.isfinite(lat) & np.isfinite(thr)
        if feasible is not None:
            ok &= np.asarray(feasible, bool).ravel()
        candidates = []
        for i in np.nonzero(ok)[0]:
            entry_metrics = ({k: float(np.asarray(v).ravel()[i])
                              for k, v in metrics.items()} if metrics else {})
            payload = payloads[i] if payloads is not None else None
            candidates.append(ArchiveEntry(
                latency=float(lat[i]), throughput=float(thr[i]),
                metrics=entry_metrics, payload=payload))
        if not candidates:
            return 0
        merged = self.entries + candidates
        m_lat = np.asarray([e.latency for e in merged])
        m_thr = np.asarray([e.throughput for e in merged])
        # existing entries come first, so they win exact ties in the scan
        keep = sorted(staircase_front(m_lat, m_thr,
                                      np.arange(len(merged)), tol=0.0))
        survivors = [merged[i] for i in keep]
        added = sum(1 for i in keep if i >= len(self.entries))
        self.entries = survivors
        return added

    def front(self) -> list[ArchiveEntry]:
        """Entries sorted by latency (throughput is then ascending too)."""
        return sorted(self.entries, key=lambda e: (e.latency, e.throughput))

    def hypervolume(self, ref_latency: float,
                    ref_throughput: float = 0.0) -> float:
        return hypervolume_2d(self.latencies, self.throughputs,
                              ref_latency, ref_throughput)

    def to_dicts(self) -> list[dict]:
        return [e.to_dict() for e in self.front()]

    @classmethod
    def from_dicts(cls, rows: list[dict]) -> "ParetoArchive":
        archive = cls()
        archive.entries = [ArchiveEntry.from_dict(r) for r in rows]
        return archive
