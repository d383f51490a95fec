# Frozen copy of src/repro/opt/space.py's AdjacencySpace.sample, repaired by perfbench/reference/repair.py.
"""The free-form adjacency genome: bit g(u, v) = link between chiplets u < v.
A sample draws every bit at the space's initial density (half the degree
cap on average) and repairs it with the reference's sequential repair.
Used only to draw the benchmark's parent pool.
"""
from __future__ import annotations

import numpy as np

from ..reference.repair import repair


def genome_length(n_chiplets: int) -> int:
    return n_chiplets * (n_chiplets - 1) // 2


def init_density(n_chiplets: int, max_degree: int) -> float:
    return min(1.0, 0.5 * max_degree / max(n_chiplets - 1, 1))


def sample(rng: np.random.Generator, size: int, n_chiplets: int,
           max_degree: int) -> np.ndarray:
    """[size, G] repaired genomes."""
    bits = (rng.random((size, genome_length(n_chiplets)))
            < init_density(n_chiplets, max_degree)).astype(np.int64)
    return repair(bits, n_chiplets, max_degree)
