"""Batched routing-table construction on the device; port of
``src/repro/routing/device.py``.

``routing/tables.py`` builds next-hop tables on the host in numpy, one
design at a time. This module builds them for whole batches of [B, n, n]
cost or adjacency stacks on the tensors' device:

* ``distances_batch`` — relay-constrained all-pairs path costs. With no
  relay constraint it is ``kernels.ops.apsp`` (the fused Hopper APSP
  kernel up to ``REPRO_APSP_FUSED_N`` nodes, the tiled squaring above); with
  one it runs the masked doubling of ``tables._relay_masked_distances``
  through ``kernels.ops.minplus_matmul``.
* ``lowest_id_next_hops_batch`` — the lowest-ID argmin next-hop selection,
  reproducing ``dijkstra_lowest_id``'s tie-breaking exactly.
* ``hops_next_hop_batch`` — the all-relay hops-metric tables of the genome
  pipeline: hop distances by BFS frontier matmuls, then the lowest-ID
  argmin as one (min, +) product of the adjacency with the exact integer
  encoding score[v, d] = dist[v, d] * (n + 1) + v.
* ``updown_candidates_batch`` — the up*/down* phase-automaton relaxation,
  returning per-(u, d) legal-candidate masks; the seeded choice stays on
  the host (``updown_random_table_via_device``) so the RNG stream, and the
  tables, equal ``updown_random_table``'s.

Every (min, +) product here goes through ``kernels.ops.minplus_matmul``,
whose BIG ceiling equals the reference's ``jnp.minimum(_minplus(..), BIG)``
wherever the reference applies it, and changes no table entry elsewhere
(entries at or above BIG are never taken). The reference's data-dependent
``while_loop``s (BFS, up*/down* fixpoint) are Python loops that read a flag
back from the device once per step; ``host_syncs()`` counts those reads.

All distances are float32: for the integer-valued "hops" metric every
comparison is exact, so the tie-breaking matches the float64 host path.
Above ``REPRO_ROUTING_BLOCK_N`` (default 160) nodes the selections stream
[n, tile] destination slabs (``REPRO_ROUTING_TILE`` pins the tile), giving
the same tables with a [B, n, tile, tile] transient instead of
[B, n, n, n]. Tables are int16 (``NH_DTYPE``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.load_prop import pick_tile
from ..kernels.ops import apsp, apsp_iters, minplus_matmul
from ..kernels.ref import BIG
from ..obs import metrics as _metrics
from ..utils import env as _env
from ..utils.device import resolve_device

NH_DTYPE = torch.int16

# Device-to-host flag reads of the data-dependent loops (metrics counter
# "routing.host_sync"), by loop: one per loop step.
HOST_SYNCS = {loop: _metrics.counter("routing.host_sync", loop=loop)
              for loop in ("bfs", "updown")}


def host_syncs() -> dict[str, int]:
    """Flag reads so far, by loop."""
    return {loop: c.value for loop, c in HOST_SYNCS.items()}


def _block_n() -> int:
    """Node count above which the selections switch to destination slabs."""
    return _env.get_int("REPRO_ROUTING_BLOCK_N")


def _block_tile(n: int, batch: int) -> int:
    return _env.get_opt_int("REPRO_ROUTING_TILE") or pick_tile(n, batch)


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def _finite_big(cost: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(torch.where(torch.isfinite(cost), cost, BIG), BIG)


def _edge_big(cost: torch.Tensor) -> torch.Tensor:
    """Map +inf/garbage non-edges to BIG; self-edges (the diagonal) count as
    non-edges for next-hop selection."""
    return torch.where(_eye(cost.shape[-1], cost.device), BIG,
                       _finite_big(cost))


def _clamp_big(cost: torch.Tensor) -> torch.Tensor:
    """Map +inf/garbage non-edges to BIG and zero the diagonal (the min-plus
    identity element, for distance computations)."""
    eye = _eye(cost.shape[-1], cost.device)
    return torch.minimum(_finite_big(cost), torch.where(eye, 0.0, BIG))


def _relay_masked_distances_batch(cost: torch.Tensor, relay: torch.Tensor,
                                  n_iters: int) -> torch.Tensor:
    """Batched twin of ``tables._relay_masked_distances``: min-plus path
    doubling with the split vertex masked to relays (the transit
    constraint), for a fixed number of steps."""
    d = _clamp_big(cost)
    relay_col = relay[:, None, :]
    for _ in range(n_iters):
        left = torch.where(relay_col, d, BIG)
        d = torch.minimum(d, minplus_matmul(left, d))
    return d


def distances_batch(cost: torch.Tensor, relay: torch.Tensor | None = None,
                    n_iters: int | None = None) -> torch.Tensor:
    """Relay-constrained all-pairs path costs [B, n, n] for a batch of
    step-cost matrices (BIG/+inf = no edge). ``relay=None`` means every
    vertex may be transited and runs ``kernels.ops.apsp``."""
    if n_iters is None:
        n_iters = apsp_iters(cost.shape[-1])
    if relay is None:
        return _finite_big(apsp(cost, n_iters))
    return _relay_masked_distances_batch(cost, relay, n_iters)


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where there is none): argmax
    returns the first maximal index, and a uint8 cast makes it run on every
    backend."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def _lowest_id_next_hops_dense(cost, dist, relay):
    n = cost.shape[-1]
    ids = torch.arange(n, device=cost.device)
    edge = cost < BIG * 0.5
    # legal[b, u, v, d] = edge(u, v) and (relay[v] or v == d)
    legal = edge[:, :, :, None] & (relay[:, None, :, None]
                                   | (ids[:, None] == ids)[None, None])
    scores = torch.where(legal, cost[:, :, :, None] + dist[:, None, :, :],
                         BIG)
    best = scores.amin(dim=2)
    # The host compares score < best + TIE_TOL in float64; for exact
    # (integer-valued) metrics that is score <= best, exact in f32.
    pick = _first_true(scores <= best[:, :, None, :], dim=2).to(NH_DTYPE)
    take = (dist < BIG * 0.5) & (ids[:, None] != ids)[None]
    return torch.where(take, pick, ids.to(NH_DTYPE)[:, None][None])


def _lowest_id_next_hops_blocked(cost, dist, relay, tile: int):
    """Destination-and-candidate-blocked twin of the dense selection: for
    each [n, tile] destination slab, a first v-slab sweep finds the best
    score and a second ascending sweep picks the first (lowest-ID) v that
    attains it. Slabs are clamped to the matrix (the last may overlap the
    one before): the minimum is idempotent, and the pick sweep keeps the
    first hit, which is the lowest ID."""
    B, n, _ = cost.shape
    dev = cost.device
    ids = torch.arange(n, device=dev)
    edge = cost < BIG * 0.5
    tile = max(1, min(tile, n))
    starts = [min(s * tile, n - tile) for s in range(-(-n // tile))]
    out = torch.empty((B, n, n), dtype=NH_DTYPE, device=dev)
    for d0 in starts:
        dids = d0 + torch.arange(tile, device=dev)
        dcol = dist[:, :, d0:d0 + tile]                          # [B, v, T]
        e = ids[:, None] == dids[None, :]                        # [n, T]

        def v_scores(v0):
            sl = slice(v0, v0 + tile)
            legal = edge[:, :, sl, None] & (relay[:, None, sl, None]
                                            | e[None, None, sl])
            return torch.where(legal, cost[:, :, sl, None]
                               + dcol[:, None, sl, :], BIG)     # [B,u,Tv,T]

        best = torch.full((B, n, tile), BIG, device=dev)
        for v0 in starts:
            best = torch.minimum(best, v_scores(v0).amin(dim=2))
        pick = torch.zeros((B, n, tile), dtype=torch.int64, device=dev)
        found = torch.zeros((B, n, tile), dtype=torch.bool, device=dev)
        for v0 in starts:
            hit = v_scores(v0) <= best[:, :, None, :]
            any_hit = hit.any(dim=2)
            pick = torch.where(any_hit & ~found, _first_true(hit, 2) + v0,
                               pick)
            found = found | any_hit
        take = (dcol < BIG * 0.5) & ~e[None]
        out[:, :, d0:d0 + tile] = torch.where(
            take, pick.to(NH_DTYPE), ids.to(NH_DTYPE)[:, None])
    return out


def lowest_id_next_hops_batch(cost: torch.Tensor, dist: torch.Tensor,
                              relay: torch.Tensor) -> torch.Tensor:
    """Batched next-hop selection with the reference's tie-breaking: for
    every (u, d) the lowest-ID legal neighbour v minimizing
    cost[u, v] + dist[v, d].

    cost: [B, n, n] with BIG non-edges (the diagonal BIG too: a vertex is
    not its own neighbour); dist: [B, n, n]; relay: [B, n] bool. Returns
    int16 [B, n, n] tables (next_hop[u, d] = u marks "no route",
    next_hop[d, d] = d)."""
    n = cost.shape[-1]
    if n > _block_n():
        return _lowest_id_next_hops_blocked(cost, dist, relay,
                                            _block_tile(n, cost.shape[0]))
    return _lowest_id_next_hops_dense(cost, dist, relay)


def _as_device_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


def next_hop_lowest_id_batch(cost, relay=None, device=None) -> np.ndarray:
    """Batched ``dijkstra_lowest_id`` tables from stacked step-cost matrices
    [B, n, n] (+inf = no edge) as int16 numpy. ``relay`` is a [B, n] bool
    mask (None = all vertices relay). A tensor stays on its device; numpy
    input goes to ``device`` (None -> cuda)."""
    cost = _edge_big(_as_device_tensor(cost, torch.float32, device))
    relay_t = (None if relay is None
               else _as_device_tensor(relay, torch.bool, cost.device))
    dist = distances_batch(cost, relay_t)
    if relay_t is None:
        relay_t = torch.ones(cost.shape[:2], dtype=torch.bool,
                             device=cost.device)
    return lowest_id_next_hops_batch(cost, dist, relay_t).cpu().numpy()


def _bfs(a: torch.Tensor, dist: torch.Tensor, reach: torch.Tensor,
         left: bool) -> torch.Tensor:
    """Frontier propagation by 0/1 matmuls until nothing new is reached (or
    n steps): dist gets the step at which each pair was first reached.
    ``left`` multiplies the frontier by the adjacency from the left (the
    blocked column slabs of a symmetric graph)."""
    n = a.shape[-1]
    k = 2
    changed = True
    while changed and k < n:
        grow = torch.matmul(a, reach) if left else torch.matmul(reach, a)
        nr = torch.clamp_max(reach + grow, 1.0)
        newly = (nr > 0) & (dist >= BIG * 0.5)
        dist = torch.where(newly, float(k), dist)
        reach = nr
        changed = bool(newly.any())
        HOST_SYNCS["bfs"].inc()
        k += 1
    return dist


def _lowest_id_pick(edge0: torch.Tensor, dist: torch.Tensor,
                    ids: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    """The lowest-ID argmin as one (min, +) product: minimizing
    edge0[u, v] + dist[v, d] * (n + 1) + v over u's neighbours v minimizes
    the hop distance first and the neighbour ID second. Every taken value
    is an integer below 2^24, exact in f32; the ID is its remainder."""
    n = edge0.shape[-1]
    score = torch.where(dist < BIG * 0.5,
                        dist * float(n + 1) + ids.to(torch.float32)[:, None],
                        BIG)
    best = minplus_matmul(edge0, score)
    best = torch.where(take, best, 0.0).to(torch.int32)
    return torch.remainder(best, n + 1).to(NH_DTYPE)


def _hops_next_hop_dense(adj: torch.Tensor) -> torch.Tensor:
    B, n, _ = adj.shape
    dev = adj.device
    a = adj.to(torch.float32)
    eye = _eye(n, dev)
    ids = torch.arange(n, device=dev)
    dist = torch.where(eye, 0.0, torch.where(adj, 1.0, BIG))
    reach = torch.clamp_max(eye.to(torch.float32) + a, 1.0)
    dist = _bfs(a, dist, reach, left=False)
    take = (dist < BIG * 0.5) & ~eye
    edge0 = torch.where(adj, 0.0, BIG)
    v = _lowest_id_pick(edge0, dist, ids, take)
    return torch.where(take, v, ids.to(NH_DTYPE)[:, None])


def _hops_next_hop_blocked(adj: torch.Tensor, tile: int) -> torch.Tensor:
    """Destination-blocked twin of the dense construction: each [n, tile]
    destination slab runs its own frontier loop (stopping at that slab's
    eccentricity) with [B, n, tile] state, and its selection is one
    [n, n] x [n, tile] (min, +) product. Relies on the adjacency being
    symmetric (the genome graphs are undirected), which lets the frontier
    grow from the source end of each column slab."""
    B, n, _ = adj.shape
    dev = adj.device
    a = adj.to(torch.float32)
    ids = torch.arange(n, device=dev)
    edge0 = torch.where(adj, 0.0, BIG)
    tile = max(1, min(tile, n))
    out = torch.empty((B, n, n), dtype=NH_DTYPE, device=dev)
    for s in range(-(-n // tile)):
        d0 = min(s * tile, n - tile)
        e = ids[:, None] == (d0 + torch.arange(tile, device=dev))[None, :]
        acol = a[:, :, d0:d0 + tile]                              # [B, v, T]
        dist = torch.where(e, 0.0, torch.where(acol > 0, 1.0, BIG))
        reach = torch.clamp_max(acol + e.to(torch.float32), 1.0)
        dist = _bfs(a, dist, reach, left=True)
        take = (dist < BIG * 0.5) & ~e
        v = _lowest_id_pick(edge0, dist, ids, take)
        out[:, :, d0:d0 + tile] = torch.where(take, v,
                                              ids.to(NH_DTYPE)[:, None])
    return out


def hops_next_hop_batch(adj: torch.Tensor) -> torch.Tensor:
    """Batched ``dijkstra_lowest_id`` tables for the genome pipeline: hops
    metric, every vertex a relay. adj: [B, n, n] bool tensor; returns int16
    tables on its device, identical to ``next_hop_lowest_id_batch``'s:

    * hop distances by BFS frontier propagation, a loop of batched 0/1
      matmuls that runs to the batch's diameter (exact at any precision);
    * the lowest-ID argmin as one (min, +) product
      (``kernels.ops.minplus_matmul``) over the integer encoding
      dist * (n + 1) + v.

    Above ``REPRO_ROUTING_BLOCK_N`` nodes the whole construction runs
    destination-blocked (``_hops_next_hop_blocked``)."""
    n = adj.shape[-1]
    adj = adj.to(torch.bool)
    if n > _block_n():
        return _hops_next_hop_blocked(adj, _block_tile(n, adj.shape[0]))
    return _hops_next_hop_dense(adj)


# ---------------------------------------------------------------------------
# up*/down* — batched phase-automaton relaxation, host RNG selection
# ---------------------------------------------------------------------------

def _updown_relax_batch(cost: torch.Tensor, relay: torch.Tensor,
                        lvl: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched twin of ``tables._updown_distances``: two coupled dense
    Bellman-Ford phases iterated to the fixpoint (the whole batch stops as
    soon as every member has converged)."""
    B, n, _ = cost.shape
    dev = cost.device
    ids = torch.arange(n, device=dev)
    eye = _eye(n, dev)
    edge = cost < BIG * 0.5
    up = edge & ((lvl[:, None, :] < lvl[:, :, None])
                 | ((lvl[:, None, :] == lvl[:, :, None])
                    & (ids[None, :] < ids[:, None])[None]))
    cost_down = torch.where(edge & ~up, cost, BIG)
    cost_up = torch.where(up, cost, BIG)
    dist0 = torch.where(eye, 0.0, BIG).expand(B, n, n)
    dist1 = torch.full_like(cost, BIG)
    # can_transit[b, w, d] = relay[w] or w == d (endpoints are always legal)
    can_transit = relay[:, :, None] | eye[None]
    i = 0
    changed = True
    while changed and i < 2 * n:
        e0 = torch.where(can_transit, dist0, BIG)
        emin = torch.minimum(e0, torch.where(can_transit, dist1, BIG))
        new0 = torch.minimum(dist0, minplus_matmul(cost_down, e0))
        new1 = torch.minimum(dist1, minplus_matmul(cost_up, emin))
        changed = bool(((new0 != dist0).any() | (new1 != dist1).any()))
        HOST_SYNCS["updown"].inc()
        dist0, dist1 = new0, new1
        i += 1
    return dist0, dist1, up


def updown_candidates_batch(cost: torch.Tensor, relay: torch.Tensor,
                            lvl: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(u, d) legal next-hop candidate masks [B, n, n, n] (axis 2 = the
    candidate v) plus the reachability distances [B, n, n], for batches of
    graphs under up*/down* routing."""
    n = cost.shape[-1]
    ids = torch.arange(n, device=cost.device)
    cost = _edge_big(cost)
    dist0, dist1, up = _updown_relax_batch(cost, relay, lvl)
    dmin = torch.minimum(dist0, dist1)
    edge = cost < BIG * 0.5
    # Stepping u -> v 'up' may continue in either phase; 'down' locks the
    # all-down suffix (phase 0).
    rest = torch.where(up[:, :, :, None], dmin[:, None, :, :],
                       dist0[:, None, :, :])
    legal = edge[:, :, :, None] & (relay[:, None, :, None]
                                   | (ids[:, None] == ids)[None, None])
    scores = torch.where(legal, cost[:, :, :, None] + rest, BIG)
    best = scores.amin(dim=2)
    # <= best == the host's < best + TIE_TOL for exact metrics
    return scores <= best[:, :, None, :], dmin


def updown_random_table_via_device(g, metric: str = "hops", seed: int = 0,
                                   root: int | None = None,
                                   device=None) -> np.ndarray:
    """``updown_random_table`` with the O(n^3) phase relaxation on
    ``device`` (None -> cuda): the candidate masks come from
    ``updown_candidates_batch``, the seeded uniform choice stays on the
    host in the reference's (d, u) order — identical RNG stream, identical
    tables."""
    from .tables import _bfs_levels, _edge_costs

    dev = resolve_device(device)
    n = g.n
    rng = np.random.default_rng(seed)
    cost = _edge_costs(g, metric)
    if root is None:
        root = int(np.argmax(g.degree()))
    lvl = _bfs_levels(g, root)
    cand, dmin = updown_candidates_batch(
        torch.as_tensor(cost, dtype=torch.float32, device=dev)[None],
        torch.as_tensor(np.asarray(g.relay, bool), device=dev)[None],
        torch.as_tensor(lvl, dtype=torch.int64, device=dev)[None])
    cand = cand[0].cpu().numpy()
    reachable = dmin[0].cpu().numpy() < BIG * 0.5
    next_hop = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, n))
    for d in range(n):
        for u in range(n):
            if u == d or not reachable[u, d]:
                continue
            cands = np.nonzero(cand[u, :, d])[0]
            next_hop[u, d] = int(rng.choice(cands))
    return next_hop


__all__ = ["NH_DTYPE", "HOST_SYNCS", "host_syncs", "distances_batch",
           "lowest_id_next_hops_batch", "next_hop_lowest_id_batch",
           "hops_next_hop_batch", "updown_candidates_batch",
           "updown_random_table_via_device"]
