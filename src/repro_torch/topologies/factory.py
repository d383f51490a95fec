# Copy of src/repro/topologies/factory.py, kept so repro_torch never imports repro.
"""Chiplet / placement / design generators (paper §2.3.1-2.3.2).

Chiplets are generated with a configurable base area plus a per-PHY area
overhead (paper §3.1: 74 mm^2 base, 0.85 mm^2 per PHY), so higher-radix
topologies pay an area cost that feeds back into link lengths and the
throughput proxy's bump budget — the "complex interplay" the paper motivates.

One chiplet *type* is shared by all placements (the chiplet-reuse story of
2.5D integration): its PHY count is the maximum degree required by the
topology; low-degree instances leave PHYs unused.

PHY placements (paper Fig. 3): ``sides`` (4 side midpoints), ``sides_corners``
(8: sides + corners), ``perimeter`` (k evenly spaced around the perimeter).
The factory auto-selects the most suitable placement for the radix.
"""
from __future__ import annotations

import math

import numpy as np

from ..core.design import (
    Chiplet, Design, Link, Packaging, Phy, PlacedChiplet, Placement,
    Technology, Topology,
)
from .registry import TOPOLOGIES, topology_edges
from .grid import grid_dims

Edge = tuple[int, int]


def phy_positions_for(kind: str, k: int, w: float, h: float) -> list[Phy]:
    """PHY coordinates for a placement pattern (paper Fig. 3)."""
    if kind == "sides":
        pts = [(w / 2, h), (w, h / 2), (w / 2, 0.0), (0.0, h / 2)]
        return [Phy(*pts[i]) for i in range(min(k, 4))]
    if kind == "sides_corners":
        pts = [(w / 2, h), (w, h / 2), (w / 2, 0.0), (0.0, h / 2),
               (0.0, 0.0), (w, 0.0), (w, h), (0.0, h)]
        return [Phy(*pts[i]) for i in range(min(k, 8))]
    if kind == "perimeter":
        # k points evenly spaced along the perimeter, starting mid-top.
        per = 2 * (w + h)
        out = []
        for i in range(k):
            s = (i / k) * per
            if s < w:                       # top edge, left->right
                out.append(Phy(s, h))
            elif s < w + h:                 # right edge, top->bottom
                out.append(Phy(w, h - (s - w)))
            elif s < 2 * w + h:             # bottom edge, right->left
                out.append(Phy(w - (s - w - h), 0.0))
            else:                           # left edge, bottom->top
                out.append(Phy(0.0, s - 2 * w - h))
        return out
    raise ValueError(f"unknown PHY placement {kind!r}")


def auto_phy_placement(radix: int) -> str:
    if radix <= 4:
        return "sides"
    if radix <= 8:
        return "sides_corners"
    return "perimeter"


def make_chiplet(radix: int, base_area: float = 74.0,
                 area_per_phy: float = 0.85,
                 base_power: float = 5.0, power_per_phy: float = 0.25,
                 internal_latency: float = 3.0, phy_latency: float = 12.0,
                 bump_area_fraction: float = 0.10,
                 technology: str = "generic_7nm",
                 phy_placement: str | None = None,
                 name: str | None = None) -> Chiplet:
    """Paper §2.3.1: configurable base area/power + per-PHY overhead; square
    chiplets (§3.1)."""
    area = base_area + area_per_phy * radix
    side = math.sqrt(area)
    kind = phy_placement or auto_phy_placement(radix)
    phys = phy_positions_for(kind, radix, side, side)
    if len(phys) < radix:
        raise ValueError(
            f"PHY placement {kind!r} supports only {len(phys)} PHYs, "
            f"topology needs radix {radix}")
    return Chiplet(
        name=name or f"compute_r{radix}",
        width=side, height=side, phys=tuple(phys),
        internal_latency=internal_latency, phy_latency=phy_latency,
        power=base_power + power_per_phy * radix,
        technology=technology, bump_area_fraction=bump_area_fraction)


def grid_placement(n: int, footprint: float, spacing: float = 1.0
                   ) -> list[tuple[float, float]]:
    """2D grid placement (paper §2.3.2), row-major, configurable spacing."""
    rows, cols = grid_dims(n)
    pitch = footprint + spacing
    return [(c * pitch, r * pitch) for r in range(rows) for c in range(cols)]


def hex_placement(n: int, footprint: float, spacing: float = 1.0
                  ) -> list[tuple[float, float]]:
    """Hexagonal placement (odd rows offset by half a pitch) for HexaMesh-
    family topologies (paper §2.3.2)."""
    rows, cols = grid_dims(n)
    pitch = footprint + spacing
    out = []
    for r in range(rows):
        # Odd rows shift by half a pitch (hexagonal adjacency); square dies
        # need the full pitch vertically to avoid overlap.
        off = (pitch / 2) if (r % 2 == 1) else 0.0
        for c in range(cols):
            out.append((c * pitch + off, r * pitch))
    return out


# Relative tolerance for PHY-distance ties: symmetric layouts produce many
# geometrically identical candidates whose float64 distances differ only in
# association-order rounding noise; comparing with a tolerance makes the
# tie-break (lowest PHY index) a property of the geometry, not of the
# summation order — which is what lets the device pipeline
# (dse/genomes.py) reproduce the assignment exactly in float32.
PHY_TIE_TOL = 1e-9


def _assign_phys(positions: list[tuple[float, float]], edges: list[Edge],
                 phys: list[Phy], footprint: float) -> dict[tuple[int, int], int]:
    """Greedy nearest-PHY assignment: for each link endpoint, pick the unused
    PHY of that chiplet closest to the neighbor's center (distance ties
    within PHY_TIE_TOL go to the lowest PHY index). Returns
    (chiplet, edge_index) -> phy index."""
    used: dict[int, set[int]] = {}
    assign: dict[tuple[int, int], int] = {}
    order = _robust_edge_order(positions, edges)
    for li in order:
        u, v = edges[li]
        for (a, b) in ((u, v), (v, u)):
            target = (positions[b][0] + footprint / 2,
                      positions[b][1] + footprint / 2)
            taken = used.setdefault(a, set())
            best_pi, best_d = None, np.inf
            for pi, phy in enumerate(phys):
                if pi in taken:
                    continue
                px, py = positions[a][0] + phy.x, positions[a][1] + phy.y
                d = abs(px - target[0]) + abs(py - target[1])
                if best_pi is None or d < best_d - PHY_TIE_TOL * max(best_d, 1.0):
                    best_d, best_pi = d, pi
            if best_pi is None:
                raise ValueError(
                    f"chiplet {a} ran out of PHYs ({len(phys)}) for its links")
            taken.add(best_pi)
            assign[(a, li)] = best_pi
    return assign


def _edge_len(positions, e: Edge) -> float:
    (ax, ay), (bx, by) = positions[e[0]], positions[e[1]]
    return abs(ax - bx) + abs(ay - by)


def _robust_edge_order(positions, edges: list[Edge]) -> list[int]:
    """Edge processing order for the greedy PHY assignment: ascending length,
    with lengths equal within PHY_TIE_TOL grouped and ordered by edge index.
    Like the PHY tie-break, this makes the order a property of the geometry
    rather than of float64 summation noise (regular placements produce many
    abstractly equal edge lengths)."""
    lens = [_edge_len(positions, e) for e in edges]
    order = sorted(range(len(edges)), key=lambda li: (lens[li], li))
    robust: list[int] = []
    group: list[int] = []
    prev = None
    for li in order:
        if prev is not None and lens[li] - prev > PHY_TIE_TOL * max(prev, 1.0):
            robust.extend(sorted(group))
            group = []
        group.append(li)
        prev = lens[li]
    robust.extend(sorted(group))
    return robust


def make_design(topology: str, n_chiplets: int,
                packaging: Packaging | None = None,
                technology: Technology | None = None,
                spacing: float = 1.0,
                routing: str = "dijkstra_lowest_id",
                routing_metric: str = "hops",
                seed: int = 0,
                chiplet_kwargs: dict | None = None,
                **topo_kwargs) -> Design:
    """Generate a complete design point: chiplet + placement + topology +
    packaging (paper §2.3 automated input generation)."""
    spec = TOPOLOGIES.get(topology)
    if spec is None and topology != "shg":
        raise ValueError(f"unknown topology {topology!r}")
    edges = topology_edges(topology, n_chiplets, **topo_kwargs)
    uses_routers = bool(spec and spec["routers"])
    placement_kind = (spec or {"placement": "grid"})["placement"]

    if uses_routers:
        # Chiplets attach to the on-interposer router at their slot with one
        # PHY; routers form the topology.
        radix = 1
    else:
        deg = np.zeros(n_chiplets, dtype=np.int64)
        for (u, v) in edges:
            deg[u] += 1
            deg[v] += 1
        radix = int(deg.max()) if len(edges) else 1

    chiplet = make_chiplet(radix, **(chiplet_kwargs or {}))
    footprint = chiplet.width
    if placement_kind == "hex":
        positions = hex_placement(n_chiplets, footprint, spacing)
    else:
        positions = grid_placement(n_chiplets, footprint, spacing)

    placed = tuple(PlacedChiplet(chiplet=chiplet.name, x=x, y=y)
                   for (x, y) in positions)

    pkg = packaging or Packaging()
    tech = technology or Technology(name=chiplet.technology)

    if uses_routers:
        pkg = Packaging(**{**pkg.__dict__, "has_interposer_routers": True})
        routers = tuple((x + footprint / 2, y + footprint / 2)
                        for (x, y) in positions)
        links = [Link(("chiplet", i, 0), ("router", i, 0))
                 for i in range(n_chiplets)]
        links += [Link(("router", u, 0), ("router", v, 0)) for (u, v) in edges]
        placement = Placement(chiplets=placed, interposer_routers=routers)
    else:
        assign = _assign_phys(positions, edges, list(chiplet.phys), footprint)
        links = [Link(("chiplet", u, assign[(u, li)]),
                      ("chiplet", v, assign[(v, li)]))
                 for li, (u, v) in enumerate(edges)]
        placement = Placement(chiplets=placed)

    name = f"{topology}_{n_chiplets}"
    if topology == "shg":
        name += f"_bits{topo_kwargs.get('bits', 0)}"
    return Design(
        name=name,
        chiplet_library=(chiplet,),
        placement=placement,
        topology=Topology(links=tuple(links)),
        packaging=pkg,
        technologies=(tech,),
        routing=routing,
        routing_metric=routing_metric,
        seed=seed,
    )
