"""The benchmark's one generator of load: a fault-grid mix read from a data
file (``perfbench/traffic/<name>.json``) turned into inputs from a seed.

A mix names its population ``population`` (genomes a call), its fault
scenarios ``scenarios`` (the pristine one and ``scenarios - 1`` i.i.d.
link-loss draws at ``link_fail_p``), the parent pool it breeds from
(``parent_pool`` genomes, drawn once), the NSGA-II variation
(``crossover_prob``; ``mutation_rate`` null = max(1/G, 0.01)) and the
closed loop (``in_flight`` calls). Every draw comes from its own stream of
``np.random.SeedSequence([seed, stream, ...])``, so the offspring of call
i are a function of (seed, i) alone and can be made again after the window
for the comparison.
"""
from __future__ import annotations

import numpy as np

from .faults import iid_link_faults
from .operators import mutate_genes, uniform_crossover
from . import space

POOL, SCENARIOS, OFFSPRING, WARMUP = range(4)   # seed streams


def seeded_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), *stream]))


class FaultGridMix:
    """Inputs of one cell: the parent pool, the fixed scenarios and a fresh
    offspring population for every call."""

    def __init__(self, mix: dict, n_chiplets: int, max_degree: int,
                 seed: int):
        self.mix = mix
        self.seed = seed
        self.population = int(mix["population"])
        self.n_scenarios = int(mix["scenarios"])
        g = space.genome_length(n_chiplets)
        self.cardinalities = np.full(g, 2, np.int64)
        rate = mix.get("mutation_rate")
        self.mutation_rate = max(1.0 / g, 0.01) if rate is None else rate
        self.crossover_prob = float(mix["crossover_prob"])
        self.pool = space.sample(seeded_rng(seed, POOL),
                                 int(mix["parent_pool"]), n_chiplets,
                                 max_degree)
        self.link_fail, self.node_fail = iid_link_faults(
            g, n_chiplets, float(mix["link_fail_p"]), self.n_scenarios - 1,
            seeded_rng(seed, SCENARIOS))

    def offspring(self, call: int, warmup: bool = False) -> np.ndarray:
        """Raw (unrepaired) offspring [population, G] of call ``call``:
        two uniformly drawn parents each, uniform crossover with probability
        ``crossover_prob``, then per-gene mutation."""
        rng = seeded_rng(self.seed, WARMUP if warmup else OFFSPRING, call)
        p = self.population
        pa = self.pool[rng.integers(0, len(self.pool), p)]
        pb = self.pool[rng.integers(0, len(self.pool), p)]
        cross = rng.random(p) < self.crossover_prob
        children = np.where(cross[:, None], uniform_crossover(pa, pb, rng),
                            pa)
        return mutate_genes(children, self.cardinalities,
                            self.mutation_rate, rng)
