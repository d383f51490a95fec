# Copy of src/repro/routing/hierarchical.py, kept so repro_torch never imports repro.
"""Hierarchical cluster-then-stitch routing construction.

HexaMesh-scale systems (hundreds of chiplets) are assembled from repeated
local neighborhoods — mesh/torus bands, hex clusters — whose diameter is
tiny compared to the system. Flat BFS-by-matmul table construction costs
O(n³) per frontier level no matter how local the topology is. This module
routes *within clusters* first, stitches clusters through a coarse gateway
graph, and only then derives the per-pair tables:

1. intra-cluster APSP on each cluster's induced subgraph (tiny matrices);
2. a gateway graph over the boundary nodes (nodes with an edge leaving
   their cluster): same-cluster gateway pairs get their intra-cluster
   distance, cross-cluster adjacent gateways get the edge weight 1;
3. APSP on the gateway graph (g × g, g ≪ n when the topology decomposes);
4. stitch: dist(u, d) = min(intra-cluster dist,
       min_{b1, b2} intra(u, b1) + gateway(b1, b2) + intra(b2, d)).

The stitched distances are EXACT for every graph and every clustering —
not an approximation: any shortest path decomposes into maximal
intra-cluster segments joined by inter-cluster edges, each segment is no
shorter than the intra-cluster distance between its endpoints, and every
stitched candidate corresponds to a real path. (Re-entering a cluster is
covered too: that is just more gateway hops.) The *speed* advantage,
however, only materializes when the boundary is small (g ≪ n): with every
node on the boundary the gateway graph IS the flat graph. ``use_clusters``
encodes that heuristic; the flat ``device.hops_next_hop_batch`` stays the
oracle and the default.

Next-hop selection replays the flat path's exact lowest-ID tie-breaking
(integer encoding score = dist · (n+1) + id) on the stitched distances, so
the emitted tables are bit-identical to the flat construction whenever the
clustering is valid — asserted in tests/test_tiled_large_n.py.

Everything here is host-facing numpy: table construction at this scale is
sweep *preparation* (done once per topology), not the per-genome inner
loop.
"""
from __future__ import annotations

import numpy as np

_INF = np.float32(np.inf)


def band_clusters(n: int, size: int) -> np.ndarray:
    """Contiguous ID bands of ``size`` nodes — the natural clustering for
    row-major grid/mesh layouts (a band = a few mesh rows) and a serviceable
    generic default."""
    return (np.arange(n) // max(1, size)).astype(np.int32)


def grid_clusters(rows: int, cols: int, crows: int, ccols: int) -> np.ndarray:
    """Cluster labels for a row-major ``rows × cols`` grid cut into
    ``crows × ccols`` tiles (HexaMesh-style local neighborhoods)."""
    r = np.arange(rows)[:, None] // crows
    c = np.arange(cols)[None, :] // ccols
    ncc = -(-cols // ccols)
    return (r * ncc + c).astype(np.int32).ravel()


def boundary_nodes(adj: np.ndarray, clusters: np.ndarray) -> np.ndarray:
    """Indices of nodes with at least one edge leaving their cluster."""
    cross = adj & (clusters[:, None] != clusters[None, :])
    return np.nonzero(cross.any(axis=1))[0]


def use_clusters(adj: np.ndarray, clusters: np.ndarray,
                 max_boundary_frac: float = 0.5) -> bool:
    """Cheap go/no-go heuristic: the hierarchical path wins when the
    gateway graph is genuinely coarse. With more than ``max_boundary_frac``
    of the nodes on a cluster boundary the stitch step approaches flat-APSP
    cost and the flat oracle should be used instead."""
    return len(boundary_nodes(adj, clusters)) <= max_boundary_frac * len(adj)


def _minplus_np(a: np.ndarray, b: np.ndarray, chunk: int = 64) -> np.ndarray:
    """(min, +) product [M, K] × [K, N] in row chunks (bounded transient)."""
    M = a.shape[0]
    out = np.empty((M, b.shape[1]), np.float32)
    for i in range(0, M, chunk):
        out[i:i + chunk] = np.min(a[i:i + chunk, :, None] + b[None], axis=1)
    return out


def _apsp_np(d: np.ndarray) -> np.ndarray:
    """In-place-ish min-plus doubling APSP on a small dense matrix."""
    n = len(d)
    m = d.astype(np.float32).copy()
    np.fill_diagonal(m, 0.0)
    for _ in range(max(1, int(np.ceil(np.log2(max(n - 1, 2)))) + 1)):
        m = np.minimum(m, _minplus_np(m, m))
    return m


def hierarchical_hops_dist(adj: np.ndarray, clusters: np.ndarray
                           ) -> np.ndarray:
    """Exact all-pairs hop distances [n, n] (np.inf = unreachable) via the
    cluster-then-stitch decomposition described in the module docstring."""
    n = len(adj)
    adj = np.asarray(adj, bool)
    clusters = np.asarray(clusters)

    # 1. intra-cluster APSP, scattered into a full matrix (the same-cluster
    #    candidate of the final min; cross-cluster entries stay inf).
    intra = np.full((n, n), _INF, np.float32)
    labels = np.unique(clusters)
    sub_dist = {}
    for c in labels:
        m = np.nonzero(clusters == c)[0]
        sub = np.where(adj[np.ix_(m, m)], 1.0, _INF).astype(np.float32)
        sub_dist[c] = _apsp_np(sub)
        intra[np.ix_(m, m)] = sub_dist[c]

    # 2. gateway graph over boundary nodes.
    gw = boundary_nodes(adj, clusters)
    g = len(gw)
    if g == 0:                       # no inter-cluster edges at all
        return intra
    gpos = {int(v): i for i, v in enumerate(gw)}
    W = np.full((g, g), _INF, np.float32)
    for c in labels:
        m = np.nonzero(clusters == c)[0]
        bc = [v for v in m if int(v) in gpos]
        if not bc:
            continue
        rows = [gpos[int(v)] for v in bc]
        sel = np.searchsorted(m, bc)
        W[np.ix_(rows, rows)] = sub_dist[c][np.ix_(sel, sel)]
    cross = adj[np.ix_(gw, gw)] & (clusters[gw][:, None] !=
                                   clusters[gw][None, :])
    W = np.where(cross, np.minimum(W, 1.0), W)

    # 3. coarse APSP.
    Dg = _apsp_np(W)

    # 4. stitch. D_ub[u, b] = intra dist from u to gateway b (same cluster
    #    only); two chunked min-plus products fold the gateway detour in.
    D_ub = np.full((n, g), _INF, np.float32)
    for c in labels:
        m = np.nonzero(clusters == c)[0]
        bc = [v for v in m if int(v) in gpos]
        if not bc:
            continue
        cols = [gpos[int(v)] for v in bc]
        sel = np.searchsorted(m, bc)
        D_ub[np.ix_(m, cols)] = sub_dist[c][:, sel]
    via = _minplus_np(_minplus_np(D_ub, Dg), D_ub.T)
    dist = np.minimum(intra, via)
    np.fill_diagonal(dist, 0.0)
    return dist


def hops_next_hop_hierarchical(adj: np.ndarray, clusters: np.ndarray,
                               chunk: int = 64) -> np.ndarray:
    """int16 next-hop table bit-identical to
    ``device.hops_next_hop_batch`` (hops metric, all-relay, lowest-ID
    tie-break), built from the stitched hierarchical distances. Chunked
    over destinations; never materializes more than [n, n, chunk]."""
    n = len(adj)
    dist = hierarchical_hops_dist(adj, clusters)
    ids = np.arange(n, dtype=np.float32)
    K = np.float32(n + 1)
    score = np.where(np.isfinite(dist), dist * K + ids[:, None],
                     _INF)                                   # [v, d]
    edge0 = np.where(np.asarray(adj, bool), 0.0, _INF).astype(np.float32)
    nh = np.tile(np.arange(n, dtype=np.int16)[:, None], (1, n))
    for d0 in range(0, n, chunk):
        sl = slice(d0, min(d0 + chunk, n))
        out = np.min(edge0[:, :, None] + score[None, :, sl], axis=1)
        out = np.where(np.isfinite(out), out, 0.0)    # masked by take below
        v = (out - K * np.floor(out / K)).astype(np.int16)
        take = np.isfinite(dist[:, sl])
        dd = np.arange(sl.start, sl.stop)
        take[dd, dd - sl.start] = False               # u == d keeps self
        nh[:, sl] = np.where(take, v, nh[:, sl])
    return nh


def hops_next_hop_auto(adj: np.ndarray, clusters: np.ndarray | None,
                       max_boundary_frac: float = 0.5,
                       device=None) -> np.ndarray:
    """Hierarchical fast path when a clustering is supplied and coarse
    enough (``use_clusters``); otherwise the flat device oracle on
    ``device`` (None -> cuda)."""
    if clusters is not None and use_clusters(adj, clusters,
                                             max_boundary_frac):
        return hops_next_hop_hierarchical(adj, clusters)
    import torch

    from ..utils.device import resolve_device
    from .device import hops_next_hop_batch

    adj_t = torch.as_tensor(np.asarray(adj, bool)[None],
                            device=resolve_device(device))
    return hops_next_hop_batch(adj_t)[0].cpu().numpy()
