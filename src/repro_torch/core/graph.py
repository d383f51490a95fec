# Copy of src/repro/core/graph.py, kept so repro_torch never imports repro.
"""Dense graph IR for the proxies (paper §2.1.2-2.1.3).

The ICI is an undirected weighted graph G=(V,E): chiplets and on-interposer
routers are vertices, links are edges. We materialize it as dense [n,n]
matrices so the JAX proxies are fixed-shape linear algebra, vmappable across
design batches and shardable across a TPU mesh.

Vertex order: chiplets first (0..n_chiplets-1), then routers.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .design import Design, DesignValidationError
from .geometry import endpoint_position, phy_positions, link_length

INF = np.float64(np.inf)


@dataclass
class DenseGraph:
    """Dense representation of one ICI design.

    adj_lat[u,v]  : latency of edge {u,v} incl. PHY latencies at chiplet
                    endpoints; +inf if no edge. Symmetric.
    adj_bw[u,v]   : bandwidth B({u,v}) in data-wires (paper eq. for B); 0 if
                    no edge. Symmetric.
    node_weight[u]: chiplet internal latency or router latency.
    relay[u]      : whether traffic may be routed *through* u.
    lengths[u,v]  : physical link length in mm (0 if no edge).
    """
    n: int
    n_chiplets: int
    node_weight: np.ndarray
    adj_lat: np.ndarray
    adj_bw: np.ndarray
    lengths: np.ndarray
    relay: np.ndarray

    @property
    def n_routers(self) -> int:
        return self.n - self.n_chiplets

    def edge_list(self) -> list[tuple[int, int]]:
        """Undirected edges as (u, v) with u < v."""
        ii, jj = np.nonzero(np.isfinite(np.triu(self.adj_lat, k=1)))
        return list(zip(ii.tolist(), jj.tolist()))

    def degree(self) -> np.ndarray:
        return np.isfinite(self.adj_lat).sum(axis=1) - np.isfinite(
            np.diag(self.adj_lat))


def _phys_per_chiplet(design: Design) -> np.ndarray:
    """Number of PHYs actually *used* by links, per chiplet (for the bump-area
    fraction f_{c,{u,v}}: the chiplet's bump area is split across its used
    PHYs)."""
    used = np.zeros(design.n_chiplets, dtype=np.int64)
    for link in design.topology.links:
        for ep in (link.a, link.b):
            if ep[0] == "chiplet":
                used[ep[1]] += 1
    return used


def link_bandwidth(area: float, bump_area_fraction: float, n_used_phys: int,
                   bump_pitch: float, non_data_wires: int) -> int:
    """Paper §2.1.3:  B({u,v}) = floor(A_c * f_{c,{u,v}} / P_c^2) - N_ndw.

    f is the fraction of the chiplet area available to *this* link's bumps: we
    split the chiplet's total bump-area fraction evenly across its used PHYs.
    """
    if n_used_phys == 0:
        return 0
    f = bump_area_fraction / n_used_phys
    b = int(np.floor(area * f / (bump_pitch ** 2))) - non_data_wires
    return max(b, 0)


def build_graph(design: Design) -> DenseGraph:
    """Construct the dense graph for one design (paper §2.1.2-2.1.3)."""
    lib = design.library()
    pkg = design.packaging
    n_c, n_r = design.n_chiplets, design.n_routers
    n = n_c + n_r

    node_weight = np.zeros(n, dtype=np.float64)
    relay = np.ones(n, dtype=bool)
    for ci, pc in enumerate(design.placement.chiplets):
        ct = lib[pc.chiplet]
        node_weight[ci] = ct.internal_latency
        relay[ci] = ct.relay
    node_weight[n_c:] = pkg.router_latency   # routers always relay

    adj_lat = np.full((n, n), INF, dtype=np.float64)
    adj_bw = np.zeros((n, n), dtype=np.float64)
    lengths = np.zeros((n, n), dtype=np.float64)
    phy_pos = phy_positions(design)
    used_phys = _phys_per_chiplet(design)

    for li, link in enumerate(design.topology.links):
        ids = []
        phy_lat = 0.0
        bw_candidates = []
        for ep in (link.a, link.b):
            kind, idx, _ = ep
            if kind == "chiplet":
                ids.append(idx)
                ct = lib[design.placement.chiplets[idx].chiplet]
                # "If the link is connected to a chiplet rather than an
                # on-interposer router, the PHY-latency is added" (§2.1.2).
                phy_lat += ct.phy_latency
                bw_candidates.append(link_bandwidth(
                    ct.area, ct.bump_area_fraction, int(used_phys[idx]),
                    pkg.bump_pitch, pkg.non_data_wires))
            else:
                ids.append(n_c + idx)
        u, v = ids
        if u == v:
            raise DesignValidationError(f"link[{li}] connects a node to itself")
        ax, ay = endpoint_position(design, link.a, phy_pos)
        bx, by = endpoint_position(design, link.b, phy_pos)
        length = link_length(ax, ay, bx, by, pkg.link_routing)
        lat = pkg.link_latency_const + pkg.link_latency_per_mm * length + phy_lat
        # The bandwidth is limited by the more constrained endpoint. Links
        # between two routers have no bump constraint; model them as the max
        # seen bandwidth of chiplet links, or a large constant if none exist.
        bw = float(min(bw_candidates)) if bw_candidates else np.inf
        if np.isfinite(adj_lat[u, v]):
            raise DesignValidationError(
                f"duplicate link between nodes {u} and {v}")
        adj_lat[u, v] = adj_lat[v, u] = lat
        adj_bw[u, v] = adj_bw[v, u] = bw
        lengths[u, v] = lengths[v, u] = length

    # Router-router links without a bump constraint: cap at the largest
    # chiplet-link bandwidth so min() in the throughput proxy stays finite.
    inf_bw = ~np.isfinite(adj_bw)
    if inf_bw.any():
        finite = adj_bw[np.isfinite(adj_bw) & (adj_bw > 0)]
        cap = float(finite.max()) if finite.size else 1.0
        adj_bw[inf_bw] = cap

    return DenseGraph(n=n, n_chiplets=n_c, node_weight=node_weight,
                      adj_lat=adj_lat, adj_bw=adj_bw, lengths=lengths,
                      relay=relay)


def step_cost_matrix(g: DenseGraph) -> np.ndarray:
    """Cost of *leaving* vertex u over edge {u,v}: node_weight[u] + edge
    latency. The proxies add node_weight[dst] once at the end, so a full path
    cost is the sum of all vertex- and edge-weights on the path (paper
    §2.1.2)."""
    return g.node_weight[:, None] + g.adj_lat


def traffic_matrix(n_chiplets: int, entries) -> np.ndarray:
    """Dense [n_chiplets, n_chiplets] traffic matrix from (s, d, a) entries."""
    t = np.zeros((n_chiplets, n_chiplets), dtype=np.float64)
    for e in entries:
        t[e.src, e.dst] += e.amount
    return t
