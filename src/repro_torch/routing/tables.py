# Copy of src/repro/routing/tables.py, kept so repro_torch never imports repro.
"""Routing-table generation (paper §2.3.4).

Two deadlock-free routing algorithms for arbitrary topologies, both built on
Dijkstra's algorithm:

1. ``dijkstra_lowest_id`` — deterministic shortest paths; among multiple
   shortest paths the next hop with the lowest ID is chosen (the paper notes
   this matches BookSim2's strategy for arbitrary topologies, at the cost of
   path diversity).

2. ``updown_random`` — randomized shortest *legal* paths under an up*/down*
   turn restriction over a BFS spanning tree. This is our stand-in for the
   paper's turn-model + cycle-breaking + dual-graph construction (see
   DESIGN.md §2 fidelity notes): same interface, same guarantee class
   (provably deadlock-free on arbitrary topologies, exploits path diversity
   via seeded random tie-breaking).

Tables are dense int32 ``next_hop[u, d]`` matrices: the next vertex on the
route from ``u`` toward destination ``d`` (``next_hop[d, d] = d``; unreachable
pairs also map to ``u`` itself and are detected by the proxies).

Routing tables are *setup*, but on large sweeps that setup dominates
wall-clock, so both algorithms are built from one **vectorized relaxation
core**: instead of a per-destination heap Dijkstra in interpreted Python, the
relay-constrained all-pairs distances are computed for *all* destinations at
once with dense min-plus relaxation in numpy (Bellman–Ford / path-doubling
over [n, n] matrices), and the next hops are selected with one batched
argmin. The original per-destination implementations are kept as
``*_reference`` oracles; equivalence is asserted in tests
(``tests/test_sweep_prep.py``).

Tables ship to the device as int32 matrices (DESIGN.md §2).
"""
from __future__ import annotations

import heapq

import numpy as np

from ..core.graph import DenseGraph, step_cost_matrix

# Tolerance used by the reference Dijkstra when comparing float path costs;
# the vectorized builders use the same value so tie-breaking is identical.
TIE_TOL = 1e-12


def _edge_costs(g: DenseGraph, metric: str) -> np.ndarray:
    """Directed step costs c[u,v] for the Dijkstra metric."""
    if metric == "hops":
        c = np.where(np.isfinite(g.adj_lat), 1.0, np.inf)
    elif metric == "latency":
        c = step_cost_matrix(g)
        c = np.where(np.isfinite(g.adj_lat), c, np.inf)
    else:
        raise ValueError(f"unknown routing metric {metric!r}")
    return c


def dijkstra_lowest_id_table_reference(g: DenseGraph,
                                       metric: str = "hops") -> np.ndarray:
    """Per-destination Dijkstra reference oracle for ``dijkstra_lowest_id``.

    For each destination d we run Dijkstra *from* d (the graph is undirected)
    to get dist_d[v], then pick
        next_hop[u, d] = argmin_v (c[u,v] + dist_d[v])
    over neighbors v, breaking ties toward the lowest vertex ID. Non-relay
    chiplets are never used as intermediate vertices.
    """
    n = g.n
    cost = _edge_costs(g, metric)
    neighbors = [np.nonzero(np.isfinite(g.adj_lat[u]))[0] for u in range(n)]
    next_hop = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, n))

    for d in range(n):
        dist = np.full(n, np.inf)
        dist[d] = 0.0
        heap = [(0.0, d)]
        done = np.zeros(n, dtype=bool)
        while heap:
            du, u = heapq.heappop(heap)
            if done[u]:
                continue
            done[u] = True
            # A packet hopping u -> ... -> d transits u, so u must relay
            # (unless u == d, the endpoint).
            if u != d and not g.relay[u]:
                continue
            for v in neighbors[u]:
                nd = du + cost[v, u]
                if nd < dist[v] - 1e-12:
                    dist[v] = nd
                    heapq.heappush(heap, (nd, int(v)))
        # Select lowest-ID next hops. Neighbor IDs are ascending, so the
        # first strict improvement wins. A neighbor is only a legal next hop
        # if it is the destination or a relay vertex.
        for u in range(n):
            if u == d or not np.isfinite(dist[u]):
                continue
            best_v, best_c = u, np.inf
            for v in neighbors[u]:
                if v != d and not g.relay[v]:
                    continue
                c = cost[u, v] + dist[v]
                if c < best_c - 1e-12:
                    best_c, best_v = c, int(v)
            next_hop[u, d] = best_v
    return next_hop


# ---------------------------------------------------------------------------
# Vectorized relaxation core (all destinations at once)
# ---------------------------------------------------------------------------

def _dest_block(n: int, budget_bytes: float = 6.4e7) -> int:
    """Destination-axis chunk size keeping the [n, n, block] float64
    relaxation temporary under ~64 MB."""
    return max(1, min(n, int(budget_bytes / 8.0 / (n * n))))


def _minplus(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """(min, +) product over [n, n] float matrices, chunked over the
    destination (column) axis to bound the broadcast temporary."""
    n = left.shape[0]
    out = np.empty_like(right)
    block = _dest_block(n)
    for d0 in range(0, n, block):
        d1 = min(n, d0 + block)
        out[:, d0:d1] = np.min(left[:, :, None] + right[None, :, d0:d1], axis=1)
    return out


def _relay_masked_distances(cost: np.ndarray, relay: np.ndarray) -> np.ndarray:
    """dist[v, d] = cheapest forward-path cost v -> d whose *intermediate*
    vertices are all relays, for every (v, d) pair simultaneously.

    Min-plus path doubling: d_{2k} = min(d_k, d_k[:, relay] (+) d_k). Masking
    the split vertex w to relays is exactly the transit constraint — w is an
    intermediate of the concatenated path, while the endpoints stay free.
    """
    n = cost.shape[0]
    dist = cost.copy()
    np.fill_diagonal(dist, 0.0)
    relay_col = np.asarray(relay, dtype=bool)[None, :]
    n_doublings = max(1, int(np.ceil(np.log2(max(n - 1, 2)))) + 1)
    for _ in range(n_doublings):
        left = np.where(relay_col, dist, np.inf)
        new = np.minimum(dist, _minplus(left, dist))
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def _lowest_id_next_hops(cost: np.ndarray, dist: np.ndarray,
                         relay: np.ndarray) -> np.ndarray:
    """Batched next-hop selection: for every (u, d) pick the lowest-ID legal
    neighbor v minimizing cost[u, v] + dist[v, d] (ties within TIE_TOL go to
    the lowest ID, matching the reference's sequential scan)."""
    n = cost.shape[0]
    ids = np.arange(n, dtype=np.int32)
    next_hop = np.tile(ids[:, None], (1, n))
    edge = np.isfinite(cost)
    relay_v = np.asarray(relay, dtype=bool)
    block = _dest_block(n)
    for d0 in range(0, n, block):
        d1 = min(n, d0 + block)
        dd = ids[d0:d1]
        legal = edge[:, :, None] & (relay_v[None, :, None] |
                                    (ids[None, :, None] == dd[None, None, :]))
        scores = np.where(legal, cost[:, :, None] + dist[None, :, d0:d1],
                          np.inf)
        best = scores.min(axis=1)
        # First True along the neighbor axis = lowest ID within tolerance.
        pick = (scores < best[:, None, :] + TIE_TOL).argmax(axis=1)
        take = np.isfinite(dist[:, d0:d1]) & (ids[:, None] != dd[None, :])
        next_hop[:, d0:d1] = np.where(take, pick.astype(np.int32),
                                      next_hop[:, d0:d1])
    return next_hop


def dijkstra_lowest_id_table(g: DenseGraph, metric: str = "hops") -> np.ndarray:
    """Deterministic shortest-path next-hop table with lowest-ID tie-break.

    Vectorized over all destinations: relay-constrained all-pairs distances
    via min-plus path doubling, then one batched lowest-ID argmin. Produces
    tables bit-identical to ``dijkstra_lowest_id_table_reference`` (asserted
    in tests/test_sweep_prep.py).
    """
    cost = _edge_costs(g, metric)
    dist = _relay_masked_distances(cost, g.relay)
    return _lowest_id_next_hops(cost, dist, g.relay)


def _bfs_levels(g: DenseGraph, root: int) -> np.ndarray:
    n = g.n
    lvl = np.full(n, -1, dtype=np.int64)
    lvl[root] = 0
    frontier = [root]
    while frontier:
        nxt = []
        for u in frontier:
            for v in np.nonzero(np.isfinite(g.adj_lat[u]))[0]:
                if lvl[v] < 0:
                    lvl[v] = lvl[u] + 1
                    nxt.append(int(v))
        frontier = nxt
    return lvl


def _is_up_edge(u: int, v: int, lvl: np.ndarray) -> bool:
    """True if traversing u->v moves 'up' (toward the root): strictly lower
    BFS level, or equal level and lower ID (the standard total order that
    makes up*/down* deadlock-free)."""
    return (lvl[v], v) < (lvl[u], u)


def updown_random_table_reference(g: DenseGraph, metric: str = "hops",
                                  seed: int = 0,
                                  root: int | None = None) -> np.ndarray:
    """Per-destination phase-automaton Dijkstra reference oracle for
    ``updown_random``.

    Legal routes traverse zero or more 'up' edges followed by zero or more
    'down' edges (no down->up turn), which provably breaks all channel-
    dependency cycles. Among equal-cost legal next hops we sample uniformly
    (seeded), restoring the path diversity that lowest-ID tie-breaking loses.
    """
    n = g.n
    rng = np.random.default_rng(seed)
    cost = _edge_costs(g, metric)
    if root is None:
        root = int(np.argmax(g.degree()))   # well-connected root shortens paths
    lvl = _bfs_levels(g, root)
    neighbors = [np.nonzero(np.isfinite(g.adj_lat[u]))[0] for u in range(n)]
    next_hop = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, n))

    # Backward Dijkstra from each destination d over the phase automaton.
    # State (v, p): p=0 -> the forward-path suffix walked so far is all 'down'
    # edges; p=1 -> we are in the 'up' prefix (every earlier forward edge must
    # also be 'up'). Reversing a forward 'down' edge keeps p=0; reversing a
    # forward 'up' edge forces p=1 forever after (in backward order).
    for d in range(n):
        dist = np.full((n, 2), np.inf)
        dist[d, 0] = 0.0
        heap = [(0.0, d, 0)]
        done = np.zeros((n, 2), dtype=bool)
        while heap:
            du, u, p = heapq.heappop(heap)
            if done[u, p]:
                continue
            done[u, p] = True
            if u != d and not g.relay[u]:
                continue
            for v in neighbors[u]:
                # Forward edge v -> u.
                up = _is_up_edge(v, u, lvl)
                if p == 0:
                    np_ = 1 if up else 0
                elif up:
                    np_ = 1
                else:
                    continue   # down edge before an up edge: illegal forward path
                nd = du + cost[v, u]
                if nd < dist[v, np_] - 1e-12:
                    dist[v, np_] = nd
                    heapq.heappush(heap, (nd, int(v), np_))
        dmin = dist.min(axis=1)
        for u in range(n):
            if u == d or not np.isfinite(dmin[u]):
                continue
            # Candidate next hops v: moving u->v must keep the remaining path
            # legal. If u->v is 'up' the rest may be anything legal from
            # (v, any phase); if 'down', the rest must be all-down (phase 0).
            cands, best_c = [], np.inf
            for v in neighbors[u]:
                if v != d and not g.relay[v]:
                    continue
                up = _is_up_edge(u, v, lvl)
                rest = min(dist[v, 0], dist[v, 1]) if up else dist[v, 0]
                c = cost[u, v] + rest
                if c < best_c - 1e-12:
                    best_c, cands = c, [int(v)]
                elif c < best_c + 1e-12:
                    cands.append(int(v))
            next_hop[u, d] = int(rng.choice(cands))
    return next_hop


def _updown_distances(cost: np.ndarray, relay: np.ndarray,
                      lvl: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Phase-automaton distances for all destinations at once; also returns
    the up-edge matrix (up[a, b]: forward edge a -> b moves 'up') so the
    caller's next-hop selection reuses it.

    dist0[v, d]: cheapest legal v -> d path whose suffix from v is all 'down'
    edges; dist1[v, d]: cheapest legal path starting with an 'up' edge (the
    'up' prefix). Transit vertices must be relays. Dense Bellman–Ford over
    the two coupled phases, iterated to the fixpoint:

        dist0 = min(dist0, cost_down (+) E0)
        dist1 = min(dist1, cost_up   (+) min(E0, E1))

    where E_p masks rows of dist_p to vertices allowed to be transited.
    """
    n = cost.shape[0]
    ids = np.arange(n)
    edge = np.isfinite(cost)
    # up[a, b]: traversing the forward edge a -> b moves 'up' (see _is_up_edge)
    up = edge & ((lvl[None, :] < lvl[:, None]) |
                 ((lvl[None, :] == lvl[:, None]) & (ids[None, :] < ids[:, None])))
    cost_down = np.where(edge & ~up, cost, np.inf)
    cost_up = np.where(up, cost, np.inf)
    dist0 = np.full((n, n), np.inf)
    np.fill_diagonal(dist0, 0.0)
    dist1 = np.full((n, n), np.inf)
    can_transit = np.asarray(relay, dtype=bool)[:, None] | np.eye(n, dtype=bool)
    for _ in range(2 * n):
        e0 = np.where(can_transit, dist0, np.inf)
        emin = np.minimum(e0, np.where(can_transit, dist1, np.inf))
        new0 = np.minimum(dist0, _minplus(cost_down, e0))
        new1 = np.minimum(dist1, _minplus(cost_up, emin))
        if np.array_equal(new0, dist0) and np.array_equal(new1, dist1):
            break
        dist0, dist1 = new0, new1
    return dist0, dist1, up


def updown_random_table(g: DenseGraph, metric: str = "hops", seed: int = 0,
                        root: int | None = None) -> np.ndarray:
    """Randomized up*/down* table with the vectorized relaxation core.

    Same phase-automaton semantics and RNG stream as the reference (asserted
    in tests/test_sweep_prep.py): the per-destination Dijkstra is replaced by
    one dense two-phase Bellman–Ford; the seeded uniform choice among
    equal-cost legal next hops walks (d, u) in the same order as before.
    """
    n = g.n
    rng = np.random.default_rng(seed)
    cost = _edge_costs(g, metric)
    if root is None:
        root = int(np.argmax(g.degree()))
    lvl = _bfs_levels(g, root)
    dist0, dist1, up = _updown_distances(cost, g.relay, lvl)
    dmin = np.minimum(dist0, dist1)
    ids = np.arange(n, dtype=np.int32)
    next_hop = np.tile(ids[:, None], (1, n))
    edge = np.isfinite(cost)
    relay_v = np.asarray(g.relay, dtype=bool)
    block = _dest_block(n)
    for d0 in range(0, n, block):
        d1 = min(n, d0 + block)
        dd = ids[d0:d1]
        # Remaining cost after stepping u -> v: an 'up' step may continue in
        # either phase, a 'down' step locks the all-down suffix (phase 0).
        rest = np.where(up[:, :, None], dmin[None, :, d0:d1],
                        dist0[None, :, d0:d1])
        legal = edge[:, :, None] & (relay_v[None, :, None] |
                                    (ids[None, :, None] == dd[None, None, :]))
        scores = np.where(legal, cost[:, :, None] + rest, np.inf)
        best = scores.min(axis=1)
        cand_mask = scores < best[:, None, :] + TIE_TOL
        # Seeded choice per (u, d), same iteration order (d outer, u inner)
        # and same per-call population sizes as the reference -> identical
        # RNG stream -> identical tables.
        for j in range(d1 - d0):
            d = d0 + j
            for u in range(n):
                if u == d or not np.isfinite(dmin[u, d]):
                    continue
                cands = np.nonzero(cand_mask[u, :, j])[0]
                next_hop[u, d] = int(rng.choice(cands))
    return next_hop


ROUTING_ALGORITHMS = {
    "dijkstra_lowest_id": dijkstra_lowest_id_table,
    "updown_random": updown_random_table,
}


def build_routing_table(g: DenseGraph, algorithm: str = "dijkstra_lowest_id",
                        metric: str = "hops", seed: int = 0) -> np.ndarray:
    if algorithm == "dijkstra_lowest_id":
        return dijkstra_lowest_id_table(g, metric)
    if algorithm == "updown_random":
        return updown_random_table(g, metric, seed)
    raise ValueError(f"unknown routing algorithm {algorithm!r}; "
                     f"options: {sorted(ROUTING_ALGORITHMS)}")


def route_walk(next_hop: np.ndarray, s: int, d: int,
               max_hops: int | None = None) -> list[int]:
    """Walk the routing table from s to d; returns the vertex sequence
    [s, ..., d]. Raises if the route does not reach d (unreachable or loop)."""
    n = next_hop.shape[0]
    if max_hops is None:
        max_hops = n + 1
    path = [s]
    cur = s
    for _ in range(max_hops):
        if cur == d:
            return path
        nxt = int(next_hop[cur, d])
        if nxt == cur:
            raise ValueError(f"no route from {s} to {d} (stuck at {cur})")
        path.append(nxt)
        cur = nxt
    raise ValueError(f"route from {s} to {d} exceeded {max_hops} hops (loop?)")


def channel_dependency_cycle(next_hop: np.ndarray) -> bool:
    """True if the channel-dependency graph induced by the routing function
    contains a cycle (i.e. the table is NOT provably deadlock-free without
    extra virtual channels). Used by property tests on updown_random tables.
    """
    n = next_hop.shape[0]
    # Channels that can be immediately followed by one another: c1=(a,b) ->
    # c2=(b,c) if for some destination d: next_hop[a,d]==b and next_hop[b,d]==c.
    deps: dict[tuple[int, int], set[tuple[int, int]]] = {}
    for d in range(n):
        for a in range(n):
            b = int(next_hop[a, d])
            if b == a:
                continue
            c = int(next_hop[b, d])
            if c == b:
                continue
            deps.setdefault((a, b), set()).add((b, c))
    # DFS cycle detection.
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict[tuple[int, int], int] = {}

    def dfs(c0) -> bool:
        stack = [(c0, iter(sorted(deps.get(c0, ()))))]
        color[c0] = GRAY
        while stack:
            node, it = stack[-1]
            found = False
            for nxt in it:
                st = color.get(nxt, WHITE)
                if st == GRAY:
                    return True
                if st == WHITE:
                    color[nxt] = GRAY
                    stack.append((nxt, iter(sorted(deps.get(nxt, ())))))
                    found = True
                    break
            if not found:
                color[node] = BLACK
                stack.pop()
        return False

    for c0 in sorted(deps):
        if color.get(c0, WHITE) == WHITE:
            if dfs(c0):
                return True
    return False
