# Copy of src/repro/faults/reference.py, kept so repro_torch never imports repro.
"""Independent host oracle for degraded (fault-masked) metrics.

The fused device grid (``dse.genomes._adjacency_eval_faults``) is tested
against this module to <= 1e-5 for every fault model. To be a genuine
oracle it shares *no* routing or propagation machinery with the device
path: structure arrays come from the exact host design build
(``core.proxies.prepare_arrays`` — pristine geometry, the same source the
host/device equivalence tests already trust), and everything downstream —
the degraded adjacency, the BFS hop distances, the lowest-id next-hop
tie-break, the per-route walk accumulating path costs and edge flows — is
plain numpy loops.

Semantics mirrored from the device grid:

* a dead link vanishes from the adjacency; a dead chiplet loses every
  incident link, relays nothing, and neither sources nor sinks traffic;
* latency / throughput are computed over *delivered* traffic only (pairs
  that can still route between alive endpoints); a scenario where nothing
  routes scores (BIG, 0.0);
* ``reachable_fraction`` is the delivered share of total offered traffic.
"""
from __future__ import annotations

import numpy as np

from ..kernels.ref import BIG


def degraded_reference(space, genome, link_fail, node_fail
                       ) -> tuple[float, float, float]:
    """(latency, throughput, reachable_fraction) of ONE genome under ONE
    fault scenario, all-numpy. genome: [G] bits; link_fail: [G] bool;
    node_fail: [n] bool."""
    from ..core.proxies import prepare_arrays

    n = space.n_chiplets
    pt = space.decode_one(np.asarray(genome, np.int64), 0)
    arrays, _ = prepare_arrays(pt.build(), validate=False)
    step_cost = np.asarray(arrays.step_cost, np.float64)
    adj_bw = np.asarray(arrays.adj_bw, np.float64)
    node_weight = np.asarray(arrays.node_weight, np.float64)
    traffic = np.asarray(pt.traffic(), np.float64)

    bits = np.asarray(genome, np.int64) % 2
    alive = ~np.asarray(node_fail, bool)
    adj = np.zeros((n, n), bool)
    for g in np.nonzero(bits & ~np.asarray(link_fail, bool))[0]:
        u, v = int(space.pair_u[g]), int(space.pair_v[g])
        if alive[u] and alive[v]:
            adj[u, v] = adj[v, u] = True

    # BFS hop distances from every destination on the degraded graph.
    dist = np.full((n, n), np.inf)
    for d in range(n):
        dist[d, d] = 0.0
        frontier = [d]
        depth = 0
        while frontier:
            depth += 1
            nxt = []
            for u in frontier:
                for v in np.nonzero(adj[u])[0]:
                    if dist[v, d] == np.inf:
                        dist[v, d] = depth
                        nxt.append(int(v))
            frontier = nxt

    # Lowest-id next hop minimizing the neighbor's hop distance (the
    # routing.device dist*(n+1)+id argmin); unreachable pairs self-loop.
    next_hop = np.tile(np.arange(n)[:, None], (1, n))
    for u in range(n):
        for d in range(n):
            if u == d or not np.isfinite(dist[u, d]):
                continue
            best, best_score = u, np.inf
            for v in np.nonzero(adj[u])[0]:
                score = dist[v, d] * (n + 1) + v
                if score < best_score:
                    best, best_score = int(v), score
            next_hop[u, d] = best

    # Per-route walk: path costs + directed edge flows of delivered pairs.
    t_tot = 0.0
    cost_sum = 0.0
    flow = np.zeros((n, n), np.float64)
    for s in range(n):
        for d in range(n):
            amt = traffic[s, d]
            if amt <= 0 or not alive[s] or not alive[d]:
                continue
            if s != d and not np.isfinite(dist[s, d]):
                continue
            t_tot += amt
            cost_sum += amt * node_weight[d]
            u = s
            while u != d:
                v = int(next_hop[u, d])
                cost_sum += amt * step_cost[u, v]
                flow[u, v] += amt
                u = v
    total_offered = float(traffic.sum())
    if t_tot <= 0:
        return float(BIG), 0.0, 0.0
    f_und = flow + flow.T
    with np.errstate(divide="ignore"):
        ratio = np.where(f_und > 0, adj_bw / np.maximum(f_und, 1e-30),
                         np.inf)
    return (float(cost_sum / t_tot), float(ratio.min() * t_tot),
            float(t_tot / max(total_offered, 1e-30)))


def degraded_reference_grid(space, genomes, scenarios) -> tuple:
    """Loop-of-singles oracle over a [P, F] grid: (latency, throughput,
    reachable_fraction) arrays shaped [P, F]."""
    genomes = np.asarray(genomes, np.int64)
    Pn = len(genomes)
    F = scenarios.n_scenarios
    lat = np.zeros((Pn, F))
    thr = np.zeros((Pn, F))
    reach = np.zeros((Pn, F))
    for p in range(Pn):
        for f in range(F):
            lat[p, f], thr[p, f], reach[p, f] = degraded_reference(
                space, genomes[p], scenarios.link_fail[f],
                scenarios.node_fail[f])
    return lat, thr, reach


__all__ = ["degraded_reference", "degraded_reference_grid"]
