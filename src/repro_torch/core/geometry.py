# Copy of src/repro/core/geometry.py, kept so repro_torch never imports repro.
"""Geometry: PHY absolute positions, link lengths, interposer bounding box.

Implements the paper's §2.1.2 link-length computation: "RapidChiplet computes
all link-lengths, considering the chiplet positions and rotations, the
placement of PHYs within the chiplets, and the link routing method (e.g.,
Manhattan, or direct)".
"""
from __future__ import annotations

import numpy as np

from .design import Design, Endpoint, DesignValidationError


def rotate_phy(px: float, py: float, w: float, h: float, rotation: int) -> tuple[float, float]:
    """Rotate a PHY's relative position by the chiplet rotation (CCW, multiples
    of 90 degrees). The chiplet footprint rotates with it, so the returned
    coordinates are relative to the rotated chiplet's lower-left corner."""
    r = rotation % 360
    if r == 0:
        return px, py
    if r == 90:
        # (x,y) -> (h - y, x); footprint becomes h x w
        return h - py, px
    if r == 180:
        return w - px, h - py
    if r == 270:
        return py, w - px
    raise DesignValidationError(f"rotation {rotation} not a multiple of 90")


def chiplet_footprint(w: float, h: float, rotation: int) -> tuple[float, float]:
    return (h, w) if rotation % 180 == 90 else (w, h)


def phy_positions(design: Design) -> np.ndarray:
    """Absolute position of every (chiplet, phy).

    Returns an object-free dense array ``pos[c][p] -> (x, y)`` encoded as a
    ragged-free array of shape [n_chiplets, max_phys, 2] with NaN padding.
    """
    lib = design.library()
    n = design.n_chiplets
    max_phys = max((len(lib[pc.chiplet].phys) for pc in design.placement.chiplets),
                   default=0)
    out = np.full((n, max(max_phys, 1), 2), np.nan, dtype=np.float64)
    for ci, pc in enumerate(design.placement.chiplets):
        ct = lib[pc.chiplet]
        for pi, phy in enumerate(ct.phys):
            rx, ry = rotate_phy(phy.x, phy.y, ct.width, ct.height, pc.rotation)
            out[ci, pi, 0] = pc.x + rx
            out[ci, pi, 1] = pc.y + ry
    return out


def endpoint_position(design: Design, ep: Endpoint,
                      phy_pos: np.ndarray | None = None) -> tuple[float, float]:
    kind, idx, phy = ep
    if kind == "router":
        return design.placement.interposer_routers[idx]
    if phy_pos is None:
        phy_pos = phy_positions(design)
    x, y = phy_pos[idx, phy]
    if np.isnan(x):
        raise DesignValidationError(f"endpoint {ep}: PHY has no position")
    return float(x), float(y)


def link_length(ax: float, ay: float, bx: float, by: float, routing: str) -> float:
    if routing == "manhattan":
        return abs(ax - bx) + abs(ay - by)
    if routing == "euclidean":
        return float(np.hypot(ax - bx, ay - by))
    raise DesignValidationError(f"unknown link routing {routing!r}")


def link_lengths(design: Design) -> np.ndarray:
    """Length of every link in design.topology, in topology order."""
    phy_pos = phy_positions(design)
    lengths = np.zeros(len(design.topology.links), dtype=np.float64)
    for li, link in enumerate(design.topology.links):
        ax, ay = endpoint_position(design, link.a, phy_pos)
        bx, by = endpoint_position(design, link.b, phy_pos)
        lengths[li] = link_length(ax, ay, bx, by, design.packaging.link_routing)
    return lengths


def interposer_bounding_box(design: Design) -> tuple[float, float, float, float]:
    """Smallest enclosing rectangle of all chiplets (paper §2.1.4).

    Returns (x0, y0, x1, y1)."""
    lib = design.library()
    x0 = y0 = np.inf
    x1 = y1 = -np.inf
    for pc in design.placement.chiplets:
        ct = lib[pc.chiplet]
        fw, fh = chiplet_footprint(ct.width, ct.height, pc.rotation)
        x0 = min(x0, pc.x)
        y0 = min(y0, pc.y)
        x1 = max(x1, pc.x + fw)
        y1 = max(y1, pc.y + fh)
    for (rx, ry) in design.placement.interposer_routers:
        x0, y0 = min(x0, rx), min(y0, ry)
        x1, y1 = max(x1, rx), max(y1, ry)
    return float(x0), float(y0), float(x1), float(y1)


def interposer_area(design: Design) -> float:
    x0, y0, x1, y1 = interposer_bounding_box(design)
    return max(0.0, (x1 - x0)) * max(0.0, (y1 - y0))


def check_overlaps(design: Design, spacing: float = 0.0) -> list[tuple[int, int]]:
    """Return pairs of chiplet indices whose footprints overlap (violating the
    placement). Used by input validation of generated placements."""
    lib = design.library()
    rects = []
    for pc in design.placement.chiplets:
        ct = lib[pc.chiplet]
        fw, fh = chiplet_footprint(ct.width, ct.height, pc.rotation)
        rects.append((pc.x, pc.y, pc.x + fw, pc.y + fh))
    bad = []
    eps = 1e-9
    for i in range(len(rects)):
        for j in range(i + 1, len(rects)):
            a, b = rects[i], rects[j]
            if (a[0] < b[2] - spacing + eps and b[0] < a[2] - spacing + eps and
                    a[1] < b[3] - spacing + eps and b[1] < a[3] - spacing + eps):
                bad.append((i, j))
    return bad
