# Copy of src/repro/traffic/trace.py, kept so repro_torch never imports repro.
"""Trace import/export (paper §2.4).

The Netraces v1.0 collection is not available offline (DESIGN.md §2), so this
module implements the *interface*: a simple line-based trace format

    cycle src dst packet_size

a writer for synthetic traces (used by tests and benchmarks), an aggregator
that folds a trace into the dense traffic-matrix format the proxies consume,
and a replay iterator for the cycle-level simulator. Custom parsers for other
trace sources can produce the same `[(cycle, src, dst, size)]` tuples.
"""
from __future__ import annotations

import numpy as np


def write_trace_file(path: str, events: list[tuple[int, int, int, int]]) -> None:
    with open(path, "w") as f:
        f.write("# cycle src dst size\n")
        for (cyc, s, d, size) in events:
            f.write(f"{cyc} {s} {d} {size}\n")


def parse_trace_file(path: str) -> list[tuple[int, int, int, int]]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cyc, s, d, size = line.split()
            events.append((int(cyc), int(s), int(d), int(size)))
    events.sort(key=lambda e: e[0])
    return events


def aggregate_trace(events: list[tuple[int, int, int, int]], n: int) -> np.ndarray:
    """Fold a trace into the dense [n, n] traffic matrix (total bytes per
    source/destination pair, normalized)."""
    t = np.zeros((n, n), dtype=np.float64)
    for (_, s, d, size) in events:
        if s != d:
            t[s, d] += size
    total = t.sum()
    if total <= 0:
        raise ValueError("trace contains no inter-chiplet traffic")
    return t / total


def synthetic_trace(n: int, n_events: int, seed: int = 0,
                    pattern: str = "random_uniform",
                    mean_interarrival: float = 2.0) -> list[tuple[int, int, int, int]]:
    """Generate a synthetic trace whose aggregate matches a named pattern."""
    from .patterns import make_traffic
    rng = np.random.default_rng(seed)
    t = make_traffic(pattern, n, seed=seed)
    flat = t.ravel() / t.sum()
    pairs = rng.choice(n * n, size=n_events, p=flat)
    cycles = np.cumsum(rng.exponential(mean_interarrival, size=n_events)).astype(np.int64)
    events = []
    for c, p in zip(cycles.tolist(), pairs.tolist()):
        s, d = divmod(p, n)
        events.append((int(c), int(s), int(d), 64))
    return events
