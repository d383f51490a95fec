# Frozen copies of src/repro/topologies/factory.py (make_chiplet, phy_positions_for, grid_placement), src/repro/topologies/grid.py (grid_dims), src/repro/core/graph.py (link_bandwidth) and src/repro/core/reports.py (die_cost, the interposer technology).
"""Per-radix chiplet tables in float64 under the default packaging and
technology (paper §3.1): square chiplets of 74 mm² plus 0.85 mm² a PHY,
PHYs at the side midpoints (radix <= 4), sides and corners (<= 8) or evenly
around the perimeter, a row-major grid placement at 1 mm spacing, the
bump-limited link bandwidth and the negative-binomial die cost."""
from __future__ import annotations

import math

import numpy as np

PACKAGING = {"link_latency_per_mm": 0.25, "link_latency_const": 0.0,
             "bump_pitch": 0.05, "non_data_wires": 2,
             "link_power_per_mm": 0.0, "link_power_const": 0.0,
             "packaging_cost_per_mm2": 0.02, "packaging_cost_base": 1.0}
TECHNOLOGY = {"wafer_radius": 150.0, "wafer_cost": 9000.0,
              "defect_density": 0.001, "critical_level_ratio": 0.5,
              "clustering_alpha": 3.0}
INTERNAL_LATENCY, PHY_LATENCY = 3.0, 12.0
BUMP_AREA_FRACTION = 0.10
SPACING = 1.0


def grid_dims(n: int) -> tuple[int, int]:
    """Nearly-square factorization R x C = n with R <= C."""
    r = int(math.floor(math.sqrt(n)))
    while n % r != 0:
        r -= 1
    return r, n // r


def phy_positions(radix: int, w: float, h: float) -> list[tuple[float, float]]:
    if radix <= 4:
        pts = [(w / 2, h), (w, h / 2), (w / 2, 0.0), (0.0, h / 2)]
        return pts[:radix]
    if radix <= 8:
        pts = [(w / 2, h), (w, h / 2), (w / 2, 0.0), (0.0, h / 2),
               (0.0, 0.0), (w, 0.0), (w, h), (0.0, h)]
        return pts[:radix]
    per = 2 * (w + h)
    out = []
    for i in range(radix):
        s = (i / radix) * per
        if s < w:
            out.append((s, h))
        elif s < w + h:
            out.append((w, h - (s - w)))
        elif s < 2 * w + h:
            out.append((w - (s - w - h), 0.0))
        else:
            out.append((0.0, s - 2 * w - h))
    return out


def link_bandwidth(area: float, n_used_phys: int) -> int:
    if n_used_phys == 0:
        return 0
    f = BUMP_AREA_FRACTION / n_used_phys
    b = int(np.floor(area * f / (PACKAGING["bump_pitch"] ** 2))) \
        - PACKAGING["non_data_wires"]
    return max(b, 0)


def die_cost(area: float, tech: dict) -> float:
    r = tech["wafer_radius"]
    dpw = max(math.floor(math.pi * r * r / area
                         - math.pi * 2.0 * r / math.sqrt(2.0 * area)), 1.0)
    d_eff = tech["defect_density"] * tech["critical_level_ratio"]
    alpha = tech["clustering_alpha"]
    y = (1.0 + area * d_eff / alpha) ** (-alpha)
    return tech["wafer_cost"] / (dpw * y)


INTERPOSER_TECHNOLOGY = {**TECHNOLOGY,
                         "wafer_cost": TECHNOLOGY["wafer_cost"] * 0.2,
                         "defect_density": TECHNOLOGY["defect_density"] * 0.1}


class RadixTables:
    """Everything that depends on the chiplet type alone, indexed by radix
    1..k: side, PHY offsets, area, power, interposer area, package cost and
    the bandwidth of a link at an endpoint of each degree."""

    def __init__(self, n: int, k: int):
        self.n, self.k = n, k
        self.side = np.zeros(k + 1)
        self.phy = np.zeros((k + 1, k, 2))
        self.area = np.zeros(k + 1)
        self.power = np.zeros(k + 1)
        self.interposer = np.zeros(k + 1)
        self.cost = np.zeros(k + 1)
        self.bw = np.zeros((k + 1, k + 2))
        rows, cols = grid_dims(n)
        for r in range(1, k + 1):
            area = 74.0 + 0.85 * r
            side = math.sqrt(area)
            self.side[r] = side
            self.phy[r, :r] = phy_positions(r, side, side)
            self.area[r] = side * side
            self.power[r] = 5.0 + 0.25 * r
            pitch = side + SPACING
            ia = ((cols - 1) * pitch + side) * ((rows - 1) * pitch + side)
            self.interposer[r] = ia
            self.cost[r] = (n * die_cost(self.area[r], TECHNOLOGY)
                            + die_cost(ia, INTERPOSER_TECHNOLOGY)
                            + PACKAGING["packaging_cost_base"]
                            + PACKAGING["packaging_cost_per_mm2"] * ia)
            for d in range(1, k + 2):
                self.bw[r, d] = link_bandwidth(self.area[r], d)
