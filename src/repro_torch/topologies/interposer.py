# Copy of src/repro/topologies/interposer.py, kept so repro_torch never imports repro.
"""Interposer-router topologies (paper §2.3.3): Double Butterfly [17],
ButterDonut [18], ClusCross [19], and Kite [20].

These topologies route traffic through a network of *on-interposer routers*
(active interposer, paper §2.1.2): every chiplet attaches to the router at
its grid slot, and the routers form the named topology.

NOTE (DESIGN.md fidelity): the exact link patterns of these four topologies
are only partially specified in public material; we implement the standard
published structure where available and a documented approximation otherwise:

* double_butterfly — per row, butterfly-style skip links at power-of-two
  distances with alternating stage offsets, plus column neighbor links.
* butterdonut    — double butterfly + row wraparound (the "donut").
* cluscross      — 2x2 quadrant clusters with internal mesh, plus cross links
  connecting opposing cluster borders (long diagonal express channels).
* kite           — mesh plus distance-2 skip links in rows and columns
  (Kite-Small flavor).

Edges are returned over *router* indices; `attach` edges connect chiplet i to
router i.
"""
from __future__ import annotations

Edge = tuple[int, int]


def _nid(r: int, c: int, cols: int) -> int:
    return r * cols + c


def _dedup(edges) -> list[Edge]:
    seen = set()
    for (u, v) in edges:
        if u != v:
            seen.add((min(u, v), max(u, v)))
    return sorted(seen)


def double_butterfly(rows: int, cols: int) -> list[Edge]:
    edges = []
    for r in range(rows):
        for c in range(cols):
            if r + 1 < rows:
                edges.append((_nid(r, c, cols), _nid(r + 1, c, cols)))
            # Row links: neighbor + butterfly skip of 2^(1 + r%2) — the
            # "double" butterfly alternates two stage patterns across rows.
            if c + 1 < cols:
                edges.append((_nid(r, c, cols), _nid(r, c + 1, cols)))
            skip = 2 << (r % 2)
            if c + skip < cols:
                edges.append((_nid(r, c, cols), _nid(r, c + skip, cols)))
    return _dedup(edges)


def butterdonut(rows: int, cols: int) -> list[Edge]:
    edges = double_butterfly(rows, cols)
    wrap = []
    for r in range(rows):
        if cols > 2:
            wrap.append((_nid(r, 0, cols), _nid(r, cols - 1, cols)))
    return _dedup(edges + wrap)


def cluscross(rows: int, cols: int) -> list[Edge]:
    rmid, cmid = rows // 2, cols // 2
    edges = []
    for r in range(rows):
        for c in range(cols):
            # mesh links within each quadrant cluster
            if c + 1 < cols and not (c + 1 == cmid):
                edges.append((_nid(r, c, cols), _nid(r, c + 1, cols)))
            if r + 1 < rows and not (r + 1 == rmid):
                edges.append((_nid(r, c, cols), _nid(r + 1, c, cols)))
    # Inter-cluster express links across the boundaries (every other lane)...
    for r in range(0, rows, 2):
        if cmid >= 1:
            edges.append((_nid(r, cmid - 1, cols), _nid(r, cmid, cols)))
    for c in range(0, cols, 2):
        if rmid >= 1:
            edges.append((_nid(rmid - 1, c, cols), _nid(rmid, c, cols)))
    # ...plus the namesake diagonal cross channels between opposing clusters.
    if rmid >= 1 and cmid >= 1:
        edges.append((_nid(rmid - 1, cmid - 1, cols), _nid(rmid, cmid, cols)))
        edges.append((_nid(rmid - 1, cmid, cols), _nid(rmid, cmid - 1, cols)))
    return _dedup(edges)


def kite(rows: int, cols: int) -> list[Edge]:
    edges = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append((_nid(r, c, cols), _nid(r, c + 1, cols)))
            if r + 1 < rows:
                edges.append((_nid(r, c, cols), _nid(r + 1, c, cols)))
            if c + 2 < cols:
                edges.append((_nid(r, c, cols), _nid(r, c + 2, cols)))
            if r + 2 < rows:
                edges.append((_nid(r, c, cols), _nid(r + 2, c, cols)))
    return _dedup(edges)
