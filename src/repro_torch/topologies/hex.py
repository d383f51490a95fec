# Copy of src/repro/topologies/hex.py, kept so repro_torch never imports repro.
"""Hexagonal-placement topologies: HexaMesh [12] and derivatives
(paper §2.3.2-2.3.3). Chiplets sit on an offset grid (odd rows shifted by
half a pitch); each chiplet has up to 6 neighbors: left/right plus four
diagonals.

Node ids remain row-major over the (rows x cols) offset grid.
"""
from __future__ import annotations

Edge = tuple[int, int]


def _nid(r: int, c: int, cols: int) -> int:
    return r * cols + c


def _hex_neighbor_offsets(r: int) -> list[tuple[int, int]]:
    """Neighbor (dr, dc) offsets for offset-row hex grids ("odd-r" layout)."""
    if r % 2 == 0:
        return [(0, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0)]
    return [(0, 1), (1, 1), (1, 0), (0, -1), (-1, 0), (-1, 1)]


def hexamesh(rows: int, cols: int) -> list[Edge]:
    edges = set()
    for r in range(rows):
        for c in range(cols):
            for (dr, dc) in _hex_neighbor_offsets(r):
                r2, c2 = r + dr, c + dc
                if 0 <= r2 < rows and 0 <= c2 < cols:
                    u, v = _nid(r, c, cols), _nid(r2, c2, cols)
                    edges.add((min(u, v), max(u, v)))
    return sorted(edges)


def hexatorus(rows: int, cols: int) -> list[Edge]:
    """HexaTorus: hexamesh with wraparound in both dimensions."""
    edges = set()
    for r in range(rows):
        for c in range(cols):
            for (dr, dc) in _hex_neighbor_offsets(r):
                r2, c2 = (r + dr) % rows, (c + dc) % cols
                u, v = _nid(r, c, cols), _nid(r2, c2, cols)
                if u != v:
                    edges.add((min(u, v), max(u, v)))
    return sorted(edges)


def folded_hexatorus(rows: int, cols: int) -> list[Edge]:
    """Folded HexaTorus: hexatorus connectivity with folded ring orderings in
    both dimensions so wraparound links stay physically short."""
    from .grid import fold_order
    row_slot = fold_order(rows)
    col_slot = fold_order(cols)
    edges = set()
    for lr in range(rows):
        for lc in range(cols):
            for (dr, dc) in _hex_neighbor_offsets(row_slot[lr]):
                lr2, lc2 = (lr + dr) % rows, (lc + dc) % cols
                u = _nid(row_slot[lr], col_slot[lc], cols)
                v = _nid(row_slot[lr2], col_slot[lc2], cols)
                if u != v:
                    edges.add((min(u, v), max(u, v)))
    return sorted(edges)
