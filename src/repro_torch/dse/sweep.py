# Copy of src/repro/dse/sweep.py, kept so repro_torch never imports repro.
"""Automated design-space exploration sweeps (paper §2.3).

The user specifies parameter *ranges* in an experiments spec (the paper's
``experiments`` file); the toolchain iterates over all combinations, generates
the inputs, and evaluates each design. ``ExperimentSpec`` is that file as a
dataclass; ``expand_experiments`` is the cartesian expansion.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from ..core.design import Design, Packaging, Technology
from ..topologies import make_design
from ..traffic import make_traffic


@dataclass(frozen=True)
class ExperimentSpec:
    """Parameter ranges for an automated DSE (paper Fig. 1 'experiment')."""
    topologies: tuple[str, ...] = ("mesh",)
    chiplet_counts: tuple[int, ...] = (16,)
    traffic_patterns: tuple[str, ...] = ("random_uniform",)
    routings: tuple[str, ...] = ("dijkstra_lowest_id",)
    packagings: tuple[Packaging, ...] = (Packaging(),)
    technologies: tuple[Technology, ...] = (Technology(),)
    # SHG parametrization sweep (case study §4): evaluated only for "shg".
    shg_bits: tuple[int, ...] = (0,)
    seeds: tuple[int, ...] = (0,)
    chiplet_kwargs: dict = field(default_factory=dict)


@dataclass(frozen=True)
class DesignPoint:
    """One fully-specified evaluation unit of the sweep."""
    index: int
    topology: str
    n_chiplets: int
    traffic_pattern: str
    routing: str
    seed: int
    shg_bits: int
    packaging: Packaging
    technology: Technology
    chiplet_kwargs_items: tuple = ()
    # Explicit link list for the "custom" topology (the optimizer's adjacency
    # genome decodes into this); empty for parametric topologies.
    links: tuple = ()

    def build(self) -> Design:
        kw = dict(self.chiplet_kwargs_items)
        topo_kwargs = {}
        if self.topology == "shg":
            topo_kwargs["bits"] = self.shg_bits
        elif self.topology == "custom":
            topo_kwargs["edges"] = self.links
        return make_design(
            self.topology, self.n_chiplets, packaging=self.packaging,
            technology=self.technology, routing=self.routing, seed=self.seed,
            chiplet_kwargs=kw, **topo_kwargs)

    def traffic(self):
        return make_traffic(self.traffic_pattern, self.n_chiplets,
                            seed=self.seed)

    def structure_key(self) -> tuple:
        """Hashable key of everything that determines the built *structure*
        (graph + routing table + step costs): all fields except ``index`` and
        ``traffic_pattern``. Sweep points sharing a key differ only in the
        traffic matrix, so the DSE encoder builds the structure once per key
        (core.structure_cache)."""
        return ("design", self.topology, self.n_chiplets, self.routing,
                self.seed, self.shg_bits, self.packaging, self.technology,
                self.chiplet_kwargs_items, self.links)


def expand_experiments(spec: ExperimentSpec) -> list[DesignPoint]:
    """Cartesian expansion of the parameter ranges into design points."""
    points = []
    idx = 0
    for (topo, n, pattern, routing, pkg, tech, seed) in itertools.product(
            spec.topologies, spec.chiplet_counts, spec.traffic_patterns,
            spec.routings, spec.packagings, spec.technologies, spec.seeds):
        bits_range = spec.shg_bits if topo == "shg" else (0,)
        for bits in bits_range:
            points.append(DesignPoint(
                index=idx, topology=topo, n_chiplets=n,
                traffic_pattern=pattern, routing=routing, seed=seed,
                shg_bits=bits, packaging=pkg, technology=tech,
                chiplet_kwargs_items=tuple(sorted(spec.chiplet_kwargs.items()))))
            idx += 1
    return points
