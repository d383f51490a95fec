# Frozen copy of src/repro/opt/space.py's AdjacencySpace._repair_one (the sequential oracle).
"""Repair of one adjacency genome, one set bit at a time: the degree cap
drops links from the highest pair index down while an endpoint is over
``max_degree``; then union-find over the surviving links, and the two
lowest-rooted components are joined at their minimum-degree (lowest-index)
chiplets until one is left."""
from __future__ import annotations

import numpy as np


def repair_one(bits: np.ndarray, n: int, max_degree: int,
               pair_u: np.ndarray, pair_v: np.ndarray) -> np.ndarray:
    bits = np.asarray(bits, np.int64) % 2
    deg = np.zeros(n, np.int64)
    set_idx = np.nonzero(bits)[0]
    np.add.at(deg, pair_u[set_idx], 1)
    np.add.at(deg, pair_v[set_idx], 1)
    for g in set_idx[::-1]:
        u, v = pair_u[g], pair_v[g]
        if deg[u] > max_degree or deg[v] > max_degree:
            bits[g] = 0
            deg[u] -= 1
            deg[v] -= 1
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for g in np.nonzero(bits)[0]:
        ru, rv = find(pair_u[g]), find(pair_v[g])
        if ru != rv:
            parent[ru] = rv
    roots = np.asarray([find(i) for i in range(n)])
    comp_ids = np.unique(roots)
    while len(comp_ids) > 1:
        members_a = np.nonzero(roots == comp_ids[0])[0]
        members_b = np.nonzero(roots == comp_ids[1])[0]
        a = members_a[np.argmin(deg[members_a])]
        b = members_b[np.argmin(deg[members_b])]
        u, v = (a, b) if a < b else (b, a)
        bits[int(u * (2 * n - u - 1) // 2 + (v - u - 1))] = 1
        deg[u] += 1
        deg[v] += 1
        roots[members_b] = comp_ids[0]
        comp_ids = np.unique(roots)
    return bits


def repair(genomes: np.ndarray, n: int, max_degree: int) -> np.ndarray:
    """``repair_one`` over the rows of a population [P, G]."""
    pair_u, pair_v = (x.astype(np.int64) for x in np.triu_indices(n, k=1))
    return np.stack([repair_one(g, n, max_degree, pair_u, pair_v)
                     for g in np.asarray(genomes, np.int64)])
