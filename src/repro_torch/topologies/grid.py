# Copy of src/repro/topologies/grid.py, kept so repro_torch never imports repro.
"""Grid-based ICI topologies (paper §2.3.3).

All generators return undirected edge lists over chiplet indices
0..R*C-1, with node id = r*C + c (row-major). Physical placement is a 2D
grid (paper §2.3.2); folded variants additionally permute the *physical*
slot of each logical node so that no link spans more than two slots
(``fold_order``).
"""
from __future__ import annotations

import math

Edge = tuple[int, int]


def _nid(r: int, c: int, cols: int) -> int:
    return r * cols + c


def grid_dims(n: int) -> tuple[int, int]:
    """Nearly-square factorization R x C = n with R <= C."""
    r = int(math.floor(math.sqrt(n)))
    while n % r != 0:
        r -= 1
    return r, n // r


def mesh(rows: int, cols: int) -> list[Edge]:
    edges = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append((_nid(r, c, cols), _nid(r, c + 1, cols)))
            if r + 1 < rows:
                edges.append((_nid(r, c, cols), _nid(r + 1, c, cols)))
    return edges


def torus(rows: int, cols: int) -> list[Edge]:
    edges = []
    for r in range(rows):
        for c in range(cols):
            if cols > 1:
                edges.append((_nid(r, c, cols), _nid(r, (c + 1) % cols, cols)))
            if rows > 1:
                edges.append((_nid(r, c, cols), _nid((r + 1) % rows, c, cols)))
    return _dedup(edges)


def fold_order(k: int) -> list[int]:
    """Physical slot of logical ring index l such that logical neighbors are
    at most 2 physical slots apart: 0, 2, 4, ..., 5, 3, 1."""
    slots = [0] * k
    for l in range(k):
        slots[l] = 2 * l if 2 * l < k else 2 * (k - 1 - l) + 1
    return slots


def folded_torus(rows: int, cols: int) -> list[Edge]:
    """Folded 2D torus [29]: torus connectivity, but the ring along each
    dimension is laid out in folded order so every link spans <= 2 grid
    pitches. Node ids are *physical* (row-major grid slots); the folding is
    applied to the logical rings."""
    col_slot = fold_order(cols)
    row_slot = fold_order(rows)
    edges = []
    for r_phys in range(rows):
        for lc in range(cols):
            if cols > 1:
                a = _nid(r_phys, col_slot[lc], cols)
                b = _nid(r_phys, col_slot[(lc + 1) % cols], cols)
                edges.append((a, b))
    for c_phys in range(cols):
        for lr in range(rows):
            if rows > 1:
                a = _nid(row_slot[lr], c_phys, cols)
                b = _nid(row_slot[(lr + 1) % rows], c_phys, cols)
                edges.append((a, b))
    return _dedup(edges)


def flattened_butterfly(rows: int, cols: int) -> list[Edge]:
    """Flattened butterfly [30]: every row and every column fully connected."""
    edges = []
    for r in range(rows):
        for c1 in range(cols):
            for c2 in range(c1 + 1, cols):
                edges.append((_nid(r, c1, cols), _nid(r, c2, cols)))
    for c in range(cols):
        for r1 in range(rows):
            for r2 in range(r1 + 1, rows):
                edges.append((_nid(r1, c, cols), _nid(r2, c, cols)))
    return edges


def shg(rows: int, cols: int, row_dists: frozenset[int] | set[int],
        col_dists: frozenset[int] | set[int]) -> list[Edge]:
    """Sparse Hamming Graph [36] (case study §4): row links at every distance
    in ``row_dists`` and column links at every distance in ``col_dists``.
    Distance 1 is always included (connectivity), so the free parameters are
    subsets of {2..cols-1} x {2..rows-1}: 2^(R+C-4) parametrizations.
    SHG(∅, ∅) == mesh; SHG(all, all) == flattened butterfly."""
    rd = {1} | set(row_dists)
    cd = {1} | set(col_dists)
    if any(d < 1 or d >= cols for d in rd):
        raise ValueError(f"row distances {sorted(rd)} out of range for {cols} cols")
    if any(d < 1 or d >= rows for d in cd):
        raise ValueError(f"col distances {sorted(cd)} out of range for {rows} rows")
    edges = []
    for r in range(rows):
        for c in range(cols):
            for d in rd:
                if c + d < cols:
                    edges.append((_nid(r, c, cols), _nid(r, c + d, cols)))
            for d in cd:
                if r + d < rows:
                    edges.append((_nid(r, c, cols), _nid(r + d, c, cols)))
    return edges


def shg_from_bits(rows: int, cols: int, bits: int) -> list[Edge]:
    """SHG parametrization from a single integer (bit i of the low C-2 bits =
    row distance i+2 present; next R-2 bits = column distances). Enumerate
    bits in range(2**(rows+cols-4)) to sweep the whole family (§4)."""
    row_dists = {d for d in range(2, cols) if (bits >> (d - 2)) & 1}
    col_dists = {d for d in range(2, rows)
                 if (bits >> (cols - 2 + d - 2)) & 1}
    return shg(rows, cols, row_dists, col_dists)


def sid_mesh(rows: int, cols: int) -> list[Edge]:
    """SID-Mesh [21]: diagonal mesh for silicon interposers — mesh links plus
    both diagonals of every grid cell. (Approximation: the original paper's
    exact diagonal pattern is not publicly specified in detail; we include
    all cell diagonals, giving the densest SID variant. Noted in DESIGN.md.)
    """
    edges = mesh(rows, cols)
    for r in range(rows - 1):
        for c in range(cols - 1):
            edges.append((_nid(r, c, cols), _nid(r + 1, c + 1, cols)))
            edges.append((_nid(r, c + 1, cols), _nid(r + 1, c, cols)))
    return edges


def octamesh(rows: int, cols: int) -> list[Edge]:
    """OctaMesh (paper §2.3.3, HexaMesh derivative [12]): every chiplet links
    to up to 8 neighbors (grid + diagonals)."""
    return sid_mesh(rows, cols)


def octatorus(rows: int, cols: int) -> list[Edge]:
    """OctaTorus: 8-neighbor connectivity with wraparound."""
    edges = []
    for r in range(rows):
        for c in range(cols):
            for (dr, dc) in ((0, 1), (1, 0), (1, 1), (1, -1)):
                r2, c2 = (r + dr) % rows, (c + dc) % cols
                if (r2, c2) != (r, c):
                    edges.append((_nid(r, c, cols), _nid(r2, c2, cols)))
    return _dedup(edges)


def folded_octatorus(rows: int, cols: int) -> list[Edge]:
    """Folded OctaTorus: octatorus connectivity over folded ring orderings
    (short physical links, as for the folded torus)."""
    col_slot = fold_order(cols)
    row_slot = fold_order(rows)
    edges = []
    for lr in range(rows):
        for lc in range(cols):
            for (dr, dc) in ((0, 1), (1, 0), (1, 1), (1, -1)):
                lr2, lc2 = (lr + dr) % rows, (lc + dc) % cols
                a = _nid(row_slot[lr], col_slot[lc], cols)
                b = _nid(row_slot[lr2], col_slot[lc2], cols)
                if a != b:
                    edges.append((a, b))
    return _dedup(edges)


def hypercube(n: int) -> list[Edge]:
    """Hypercube [31] for n a power of two (node ids = physical grid slots in
    row-major order; logical hypercube addresses = node ids)."""
    if n & (n - 1) != 0:
        raise ValueError(f"hypercube needs a power-of-two chiplet count, got {n}")
    dims = n.bit_length() - 1
    edges = []
    for u in range(n):
        for b in range(dims):
            v = u ^ (1 << b)
            if u < v:
                edges.append((u, v))
    return edges


def _dedup(edges: list[Edge]) -> list[Edge]:
    seen = set()
    out = []
    for (u, v) in edges:
        if u == v:
            continue
        key = (min(u, v), max(u, v))
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out
