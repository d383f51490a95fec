# Copy of src/repro/core/reports.py, kept so repro_torch never imports repro.
"""Area, power, and cost reports (paper §2.1.4).

* Area: sum of chiplet areas + interposer area (smallest enclosing rectangle).
* Power: sum of per-chiplet power + per-router power + (optionally
  length-dependent) link power.
* Cost: negative-binomial yield model per chiplet, dies-per-wafer geometry,
  plus interposer/packaging cost.

These are host-side (numpy) — they are cheap per design and feed the DSE
filters; the JAX hot loop is the latency/throughput proxies.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .design import Design, Technology
from .geometry import interposer_area, link_lengths


@dataclass(frozen=True)
class AreaReport:
    total_chiplet_area: float
    interposer_area: float


@dataclass(frozen=True)
class PowerReport:
    chiplet_power: float
    router_power: float
    link_power: float

    @property
    def total(self) -> float:
        return self.chiplet_power + self.router_power + self.link_power


@dataclass(frozen=True)
class CostReport:
    chiplet_costs: tuple[float, ...]
    interposer_cost: float
    packaging_cost: float

    @property
    def total(self) -> float:
        return sum(self.chiplet_costs) + self.interposer_cost + self.packaging_cost


def area_report(design: Design) -> AreaReport:
    lib = design.library()
    total = sum(lib[pc.chiplet].area for pc in design.placement.chiplets)
    return AreaReport(total_chiplet_area=total,
                      interposer_area=interposer_area(design))


def power_report(design: Design) -> PowerReport:
    lib = design.library()
    pkg = design.packaging
    chip_p = sum(lib[pc.chiplet].power for pc in design.placement.chiplets)
    router_p = pkg.router_power * design.n_routers
    lengths = link_lengths(design)
    link_p = float(np.sum(pkg.link_power_const + pkg.link_power_per_mm * lengths))
    return PowerReport(chiplet_power=chip_p, router_power=router_p,
                       link_power=link_p)


def die_yield_batch(area, defect_density, critical_level_ratio,
                    clustering_alpha) -> np.ndarray:
    """Vectorized negative-binomial yield model:
        Y = (1 + A * D0 * r / alpha)^(-alpha)
    with D0 the defect density, r the critical-level ratio, alpha the
    clustering parameter. All arguments broadcast."""
    d_eff = np.asarray(defect_density, np.float64) * critical_level_ratio
    alpha = np.asarray(clustering_alpha, np.float64)
    return (1.0 + np.asarray(area, np.float64) * d_eff / alpha) ** (-alpha)


def dies_per_wafer_batch(area, wafer_radius) -> np.ndarray:
    """Vectorized geometric approximation: pi*R^2/A - pi*2R/sqrt(2A)."""
    r = np.asarray(wafer_radius, np.float64)
    a = np.asarray(area, np.float64)
    n = np.pi * r * r / a - np.pi * 2.0 * r / np.sqrt(2.0 * a)
    return np.maximum(np.floor(n), 1.0)


def die_cost_batch(area, wafer_cost, wafer_radius, defect_density,
                   critical_level_ratio, clustering_alpha) -> np.ndarray:
    """Vectorized per-good-die cost: wafer cost split over good dies."""
    dpw = dies_per_wafer_batch(area, wafer_radius)
    y = die_yield_batch(area, defect_density, critical_level_ratio,
                        clustering_alpha)
    return np.asarray(wafer_cost, np.float64) / (dpw * y)


def die_yield(area: float, tech: Technology) -> float:
    d_eff = tech.defect_density * tech.critical_level_ratio
    return float((1.0 + area * d_eff / tech.clustering_alpha)
                 ** (-tech.clustering_alpha))


def dies_per_wafer(area: float, tech: Technology) -> int:
    return int(dies_per_wafer_batch(area, tech.wafer_radius))


def die_cost(area: float, tech: Technology) -> float:
    """Per-good-die cost: wafer cost split over good dies."""
    return tech.wafer_cost / (dies_per_wafer(area, tech) * die_yield(area, tech))


def _interposer_tech_default(design: Design) -> Technology:
    """The interposer is manufactured in a mature node: a relaxed copy of the
    first technology with 10x lower defect density (interposers use old
    processes). Shared by the per-design and batched cost paths."""
    t0 = design.technologies[0]
    return Technology(
        name="interposer", wafer_radius=t0.wafer_radius,
        wafer_cost=t0.wafer_cost * 0.2,
        defect_density=t0.defect_density * 0.1,
        critical_level_ratio=t0.critical_level_ratio,
        clustering_alpha=t0.clustering_alpha)


def cost_report(design: Design, interposer_tech: Technology | None = None
                ) -> CostReport:
    """Paper §2.1.4: per-chiplet costs (yield model) + packaging cost."""
    lib = design.library()
    tech = design.technology_map()
    chip_costs = tuple(
        die_cost(lib[pc.chiplet].area, tech[lib[pc.chiplet].technology])
        for pc in design.placement.chiplets)
    ia = interposer_area(design)
    if interposer_tech is None:
        interposer_tech = _interposer_tech_default(design)
    interposer_cost = die_cost(ia, interposer_tech) if ia > 0 else 0.0
    packaging_cost = (design.packaging.packaging_cost_base +
                      design.packaging.packaging_cost_per_mm2 * ia)
    return CostReport(chiplet_costs=chip_costs,
                      interposer_cost=interposer_cost,
                      packaging_cost=packaging_cost)


@dataclass(frozen=True)
class ReportArrays:
    """Per-design report scalars stacked over the design axis [B].

    This is the batched form the optimizer's constraint masks consume
    (area/power/cost budgets over whole populations); numbers match the
    per-design reports above exactly.

    ``reachable_fraction`` surfaces disconnection explicitly:
    the fraction of ordered chiplet pairs (s != d) connected by the link
    graph — 1.0 for any connected design. The throughput proxy used to be
    the only signal (unreachable-pair flow accumulates on the next-hop
    self-loop diagonal and silently drives the proxy toward 0, see
    ``core.throughput.edge_flows``); this column makes the failure mode a
    first-class report instead. Defaults to all-ones when a constructor
    predates the column (old checkpoints, minimal tests)."""
    total_chiplet_area: np.ndarray
    interposer_area: np.ndarray
    power: np.ndarray
    cost: np.ndarray
    reachable_fraction: np.ndarray | None = None

    def __post_init__(self):
        if self.reachable_fraction is None:
            object.__setattr__(self, "reachable_fraction",
                               np.ones_like(np.asarray(self.power,
                                                       np.float64)))

    @property
    def total_area(self) -> np.ndarray:
        return self.total_chiplet_area + self.interposer_area


def connected_fraction(n_chiplets: int, n_routers: int, links) -> float:
    """Fraction of ordered chiplet pairs (s != d) connected through the
    link graph (chiplets + interposer routers as relay vertices); 1.0 when
    the design is connected, 0.0 when every chiplet is isolated.

    Pure-numpy union-find — deliberately independent of the routing
    machinery so the device path's reachable-fraction metric has a host
    oracle to test against."""
    n_total = n_chiplets + n_routers
    if n_chiplets <= 1:
        return 1.0
    parent = np.arange(n_total)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:        # path compression
            parent[x], x = root, parent[x]
        return root

    def node_id(endpoint) -> int:
        kind, idx = endpoint[0], endpoint[1]
        return idx if kind == "chiplet" else n_chiplets + idx

    for link in links:
        ra, rb = find(node_id(link.a)), find(node_id(link.b))
        if ra != rb:
            parent[ra] = rb
    roots = np.asarray([find(i) for i in range(n_chiplets)])
    _, counts = np.unique(roots, return_counts=True)
    pairs = float(np.sum(counts * (counts - 1)))
    return pairs / float(n_chiplets * (n_chiplets - 1))


def adjacency_connected_fraction(bits: np.ndarray, pair_u: np.ndarray,
                                 pair_v: np.ndarray, n: int) -> np.ndarray:
    """``connected_fraction`` for a batch of adjacency bit-genomes [P, G]
    over the upper-triangle pair lists (``opt.space.AdjacencySpace``):
    fraction of ordered chiplet pairs (s != d) connected per genome."""
    bits = np.asarray(bits) % 2
    out = np.ones(len(bits), np.float64)
    if n <= 1:
        return out
    for b, row in enumerate(bits):
        parent = np.arange(n)

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for g in np.nonzero(row)[0]:
            ra, rb = find(int(pair_u[g])), find(int(pair_v[g]))
            if ra != rb:
                parent[ra] = rb
        roots = np.asarray([find(i) for i in range(n)])
        _, counts = np.unique(roots, return_counts=True)
        out[b] = float(np.sum(counts * (counts - 1))) / float(n * (n - 1))
    return out


def report_arrays(designs) -> ReportArrays:
    """Area/power/cost reports for a population of designs at once.

    Geometry (interposer bounding box, link lengths) stays per-design; the
    yield/cost arithmetic — the bulk of the report math on large populations —
    runs vectorized over one flattened chiplet axis with a segment-sum back to
    the design axis."""
    designs = list(designs)
    B = len(designs)
    if B == 0:
        z = np.zeros(0, np.float64)
        return ReportArrays(z, z, z, z, z)

    # Flatten every placed chiplet of every design into one axis.
    seg, c_area, c_power = [], [], []
    c_wradius, c_wcost, c_dd, c_clr, c_alpha = [], [], [], [], []
    ia = np.zeros(B, np.float64)
    router_p = np.zeros(B, np.float64)
    link_p = np.zeros(B, np.float64)
    pkg_cost = np.zeros(B, np.float64)
    i_wradius, i_wcost, i_dd, i_clr, i_alpha = (
        np.zeros(B, np.float64) for _ in range(5))
    reach = np.ones(B, np.float64)
    for b, d in enumerate(designs):
        reach[b] = connected_fraction(d.n_chiplets, d.n_routers,
                                      d.topology.links)
        lib = d.library()
        tech = d.technology_map()
        pkg = d.packaging
        for pc in d.placement.chiplets:
            ct = lib[pc.chiplet]
            t = tech[ct.technology]
            seg.append(b)
            c_area.append(ct.area)
            c_power.append(ct.power)
            c_wradius.append(t.wafer_radius)
            c_wcost.append(t.wafer_cost)
            c_dd.append(t.defect_density)
            c_clr.append(t.critical_level_ratio)
            c_alpha.append(t.clustering_alpha)
        ia[b] = interposer_area(d)
        lengths = link_lengths(d)
        router_p[b] = pkg.router_power * d.n_routers
        link_p[b] = float(np.sum(pkg.link_power_const +
                                 pkg.link_power_per_mm * lengths))
        pkg_cost[b] = pkg.packaging_cost_base + pkg.packaging_cost_per_mm2 * ia[b]
        it = _interposer_tech_default(d)
        i_wradius[b], i_wcost[b] = it.wafer_radius, it.wafer_cost
        i_dd[b], i_clr[b], i_alpha[b] = (it.defect_density,
                                         it.critical_level_ratio,
                                         it.clustering_alpha)

    seg = np.asarray(seg, np.int64)
    c_area = np.asarray(c_area, np.float64)
    chip_area = np.bincount(seg, weights=c_area, minlength=B)
    chip_power = np.bincount(seg, weights=np.asarray(c_power, np.float64),
                             minlength=B)
    chip_cost = die_cost_batch(c_area, c_wcost, c_wradius, c_dd, c_clr,
                               c_alpha)
    cost = np.bincount(seg, weights=chip_cost, minlength=B) + pkg_cost
    has_ia = ia > 0
    if has_ia.any():
        icost = die_cost_batch(np.where(has_ia, ia, 1.0), i_wcost,
                               i_wradius, i_dd, i_clr, i_alpha)
        cost = cost + np.where(has_ia, icost, 0.0)
    return ReportArrays(total_chiplet_area=chip_area, interposer_area=ia,
                        power=chip_power + router_p + link_p, cost=cost,
                        reachable_fraction=reach)
