# Copy of src/repro/core/reference.py, kept so repro_torch never imports repro.
"""Scalar pure-Python reference implementation of the paper's proxies.

This transcribes §2.1.2 / §2.1.3 literally (per-pair route walks, per-edge
dict counters) and serves as the oracle for the PyTorch implementations in
latency.py / throughput.py. Deliberately unoptimized: float64 and scalar,
so it can hold the card's results on a machine without the reference
package.
"""
from __future__ import annotations

import numpy as np

from .graph import DenseGraph
from ..routing.tables import route_walk


def latency_reference(g: DenseGraph, next_hop: np.ndarray,
                      traffic: np.ndarray) -> float:
    """Average packet latency: traffic-weighted mean over routed paths of the
    sum of all vertex- and edge-weights on the path."""
    num = 0.0
    den = 0.0
    n_c = traffic.shape[0]
    for s in range(n_c):
        for d in range(n_c):
            a = traffic[s, d]
            if a <= 0 or s == d:
                continue
            path = route_walk(next_hop, s, d)
            lat = 0.0
            for v in path:
                lat += g.node_weight[v]
            for u, v in zip(path[:-1], path[1:]):
                lat += g.adj_lat[u, v]
            num += a * lat
            den += a
    return num / den


def edge_flows_reference(g: DenseGraph, next_hop: np.ndarray,
                         traffic: np.ndarray) -> dict[tuple[int, int], float]:
    """F({u,v}) per undirected edge (keys with u < v)."""
    flows: dict[tuple[int, int], float] = {}
    n_c = traffic.shape[0]
    for s in range(n_c):
        for d in range(n_c):
            a = traffic[s, d]
            if a <= 0 or s == d:
                continue
            path = route_walk(next_hop, s, d)
            for u, v in zip(path[:-1], path[1:]):
                key = (min(u, v), max(u, v))
                flows[key] = flows.get(key, 0.0) + a
    return flows


def throughput_reference(g: DenseGraph, next_hop: np.ndarray,
                         traffic: np.ndarray) -> float:
    """T = min_e B(e)/F(e) * total_traffic."""
    flows = edge_flows_reference(g, next_hop, traffic)
    min_ratio = np.inf
    for (u, v), f in flows.items():
        if f > 0:
            min_ratio = min(min_ratio, g.adj_bw[u, v] / f)
    return float(min_ratio * traffic.sum())
