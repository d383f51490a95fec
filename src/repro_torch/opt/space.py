# Port of src/repro/opt/space.py: the same spaces; the degree-cap scan is a
# host loop instead of a jitted fori_loop.
"""Genome ⇄ DesignPoint encodings for the design-space optimizers.

Two search spaces over the paper's design space:

* ``ParametricSpace`` — categorical genome over the registered parametric
  topologies × chiplet counts × routings (+ an SHG bits gene, active only
  when the topology gene decodes to "shg");
* ``AdjacencySpace`` — PlaceIT-style free-form topologies: one bit per
  unordered chiplet pair, decoded through the ``custom`` topology entry's
  explicit link list, with deterministic validity *repair* (degree capping +
  connectivity) so every genome decodes to a buildable, connected design.

Genomes are int64 arrays [P, G]; ``repair`` is a pure function of the genome
(no RNG), which the checkpoint/resume story relies on.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.design import Packaging, Technology
from ..dse.sweep import DesignPoint
from ..topologies.grid import grid_dims

# Parametric topologies valid for any chiplet count (hypercube needs powers
# of two; router topologies double the node count — both opt-in).
DEFAULT_TOPOLOGIES = (
    "mesh", "torus", "folded_torus", "flattened_butterfly", "shg",
    "sid_mesh", "octamesh", "octatorus", "folded_octatorus",
    "hexamesh", "hexatorus", "folded_hexatorus",
)
_ROUTER_TOPOS = ("double_butterfly", "butterdonut", "cluscross", "kite")


class SearchSpace:
    """Base interface: integer genomes with per-gene cardinalities."""

    genome_length: int
    cardinalities: np.ndarray     # int64 [G]
    max_nodes: int                # padded node count for the proxy batch

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """[size, G] valid (already repaired) genomes."""
        raise NotImplementedError

    def repair(self, genomes: np.ndarray) -> np.ndarray:
        """Deterministically map arbitrary genomes to valid ones — a pure
        function of the genome, so optimizer trajectories replay exactly."""
        raise NotImplementedError

    def decode_one(self, genome: np.ndarray, index: int) -> DesignPoint:
        raise NotImplementedError

    def decode(self, genomes: np.ndarray,
               start_index: int = 0) -> list[DesignPoint]:
        return [self.decode_one(g, start_index + i)
                for i, g in enumerate(np.asarray(genomes, np.int64))]

    def describe(self, genome: np.ndarray) -> dict:
        """Human-readable summary of one genome (for result files)."""
        pt = self.decode_one(np.asarray(genome, np.int64), 0)
        return {"topology": pt.topology, "n_chiplets": pt.n_chiplets,
                "routing": pt.routing, "shg_bits": pt.shg_bits,
                "n_links": len(pt.links)}


@dataclass
class ParametricSpace(SearchSpace):
    """Genome = [topology, chiplet-count, routing, shg-bits] categorical
    indices over the registered generators."""

    topologies: tuple = DEFAULT_TOPOLOGIES
    chiplet_counts: tuple = (16, 36, 64)
    routings: tuple = ("dijkstra_lowest_id",)
    shg_bits_choices: tuple = tuple(range(16))
    traffic_pattern: str = "random_uniform"
    seed: int = 0
    packaging: Packaging = field(default_factory=Packaging)
    technology: Technology = field(default_factory=Technology)

    def __post_init__(self):
        self.cardinalities = np.asarray(
            [len(self.topologies), len(self.chiplet_counts),
             len(self.routings), max(len(self.shg_bits_choices), 1)],
            np.int64)
        self.genome_length = 4
        mult = 2 if any(t in _ROUTER_TOPOS for t in self.topologies) else 1
        self.max_nodes = max(self.chiplet_counts) * mult

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        return rng.integers(0, self.cardinalities[None, :],
                            size=(size, self.genome_length))

    def repair(self, genomes: np.ndarray) -> np.ndarray:
        return np.asarray(genomes, np.int64) % self.cardinalities[None, :]

    def decode_one(self, genome: np.ndarray, index: int) -> DesignPoint:
        topo_i, count_i, routing_i, bits_i = (int(v) for v in genome)
        topology = self.topologies[topo_i]
        n = self.chiplet_counts[count_i]
        bits = 0
        if topology == "shg":
            bits = int(self.shg_bits_choices[bits_i])
            r, c = grid_dims(n)
            bits %= 2 ** (r + c - 4)     # clamp to the grid's parametrization
        return DesignPoint(
            index=index, topology=topology, n_chiplets=n,
            traffic_pattern=self.traffic_pattern,
            routing=self.routings[routing_i], seed=self.seed, shg_bits=bits,
            packaging=self.packaging, technology=self.technology)

    def enumerate_genomes(self) -> np.ndarray:
        """Every *distinct* design in the space (the exhaustive-sweep
        baseline). The SHG-bits gene is inert for non-shg topologies, so it
        is enumerated only where it changes the decoded design — a cartesian
        product over all four genes would hand the sweep mostly duplicate
        evaluations."""
        rows = []
        for ti, topo in enumerate(self.topologies):
            for ci, n in enumerate(self.chiplet_counts):
                if topo == "shg":
                    # decode clamps the chosen bits *value* to the grid's
                    # parametrization; emit one index per distinct clamped
                    # value so the enumeration never repeats a design
                    r, c = grid_dims(n)
                    mod = 2 ** (r + c - 4)
                    seen_vals: set[int] = set()
                    bits_range = []
                    for bi, choice in enumerate(self.shg_bits_choices):
                        v = int(choice) % mod
                        if v not in seen_vals:
                            seen_vals.add(v)
                            bits_range.append(bi)
                else:
                    bits_range = [0]
                for ri in range(len(self.routings)):
                    for bi in bits_range:
                        rows.append((ti, ci, ri, bi))
        return np.asarray(rows, np.int64)


@dataclass
class AdjacencySpace(SearchSpace):
    """Free-form topology genome: bit g(u,v) = link between chiplets u < v.

    ``repair`` makes any bit-vector a valid design, deterministically:

    1. degree cap — scan set bits from the highest pair index down and clear
       any whose endpoints both stay connected but exceed ``max_degree``;
    2. connectivity — union components by adding a link between each
       component's minimum-degree chiplet (ties toward the lowest index).
       A join may exceed the cap by one when a component is saturated;
       the cap is a soft area-control bound, the chiplet radix follows the
       realized degree.
    """

    n_chiplets: int = 32
    max_degree: int = 8
    init_density: float | None = None   # default: target max_degree/2 average
    traffic_pattern: str = "random_uniform"
    routing: str = "dijkstra_lowest_id"
    seed: int = 0
    packaging: Packaging = field(default_factory=Packaging)
    technology: Technology = field(default_factory=Technology)

    def __post_init__(self):
        n = self.n_chiplets
        iu = np.triu_indices(n, k=1)
        self.pair_u = iu[0].astype(np.int64)
        self.pair_v = iu[1].astype(np.int64)
        self.genome_length = len(self.pair_u)
        self.cardinalities = np.full(self.genome_length, 2, np.int64)
        self.max_nodes = n
        # Incidence matrix [G, n]: degrees of a population are one matmul
        # (kept in float32 — a BLAS sgemm beats the int64 path ~20x, and
        # degree counts ≤ n-1 are exactly representable).
        self._incidence = np.zeros((self.genome_length, n), np.float32)
        self._incidence[np.arange(self.genome_length), self.pair_u] = 1
        self._incidence[np.arange(self.genome_length), self.pair_v] = 1
        if self.init_density is None:
            self.init_density = min(1.0, 0.5 * self.max_degree / max(n - 1, 1))

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        bits = (rng.random((size, self.genome_length))
                < self.init_density).astype(np.int64)
        return self.repair(bits)

    def degrees(self, genomes: np.ndarray) -> np.ndarray:
        """Vertex degrees [P, n] of a population of bit genomes."""
        bits = np.asarray(genomes, np.int64) % 2
        return (bits.astype(np.float32) @ self._incidence).astype(np.int64)

    def repair(self, genomes: np.ndarray) -> np.ndarray:
        """Vectorized over the whole population: the degree-cap pass is one
        descending scan over gene columns ([P] updates per column), the
        connectivity pass replicates ``_repair_one``'s union-find root
        labeling with pointer-doubling gathers and merges every genome's
        components in lockstep. Bit-identical to mapping ``_repair_one`` over
        the rows (asserted in tests/test_device_path.py)."""
        bits = np.asarray(genomes, np.int64) % 2
        P, G = bits.shape
        if P == 0:
            return bits
        n = self.n_chiplets
        pu, pv = self.pair_u, self.pair_v
        bits = bits.copy()
        deg = self.degrees(bits)
        self._degree_cap(bits, deg)

        # 2. connectivity — only for genomes that need it. Connected ⟺
        # every vertex reachable from vertex 0. The frontier expansion runs
        # edge-wise through the incidence matrix — activate every set gene
        # with a reached endpoint, scatter back to both endpoints via one
        # sgemm — so the transient stays [P, G] (the genome's own footprint)
        # instead of a dense [P, n, n] adjacency stack; already-connected
        # genomes (the steady-state majority after variation) skip the
        # union-find scan entirely.
        bf = (bits == 1).astype(np.float32)
        reach = np.zeros((P, n), np.float32)
        reach[:, 0] = 1.0
        while True:
            active = bf * (reach[:, pu] + reach[:, pv])
            new = np.minimum(reach + active @ self._incidence, 1.0)
            if np.array_equal(new, reach):
                break
            reach = new
        bad = np.nonzero(reach.min(axis=1) == 0)[0]
        if len(bad):
            bits[bad] = self._connect_batch(bits[bad], deg[bad])
        return bits

    def _degree_cap(self, bits: np.ndarray, deg: np.ndarray) -> None:
        """1. degree cap, in place on ``bits`` [P, G] and ``deg`` [P, n],
        dropping from the highest pair index down. Dropping only ever
        *decrements* degrees, so a vertex not over the cap at the start
        never goes over later, and the scan touches exactly the columns that
        are set somewhere AND incident to an initially over-cap vertex. The
        scan is loop-carried (each drop changes the degrees later columns
        see): one host step per candidate column, with [P]-wide integer
        updates, bit-identical to the sequential scan of ``_repair_one``."""
        maxd, pu, pv = self.max_degree, self.pair_u, self.pair_v
        over = deg > maxd
        if over.any():
            cand = ((bits == 1) &
                    (over[:, pu] | over[:, pv])).any(axis=0)
            for g in np.nonzero(cand)[0][::-1]:
                u, v = pu[g], pv[g]
                drop = ((bits[:, g] == 1)
                        & ((deg[:, u] > maxd) | (deg[:, v] > maxd))
                        ).astype(np.int64)
                bits[:, g] -= drop
                deg[:, u] -= drop
                deg[:, v] -= drop

    def _connect_batch(self, bits: np.ndarray, deg: np.ndarray) -> np.ndarray:
        """Connectivity repair for a (sub)population of degree-capped
        genomes, replicating the union-find root labels of ``_repair_one``:
        surviving genes are processed in ascending order, and the invariant
        "parent is fully path-compressed before each union" makes one
        pointer-doubling gather per gene sufficient. Components are then
        unioned in lockstep, each genome joining its two lowest-rooted
        components at their minimum-degree (lowest-index) chiplets — the
        same deterministic rule as the sequential pass."""
        P, _ = bits.shape
        n = self.n_chiplets
        pu, pv = self.pair_u, self.pair_v
        rows = np.arange(P)
        parent = np.tile(np.arange(n), (P, 1))
        for g in np.nonzero(bits.any(axis=0))[0]:
            parent = parent[rows[:, None], parent]
            ru = parent[rows, pu[g]]
            rv = parent[rows, pv[g]]
            m = (bits[:, g] == 1) & (ru != rv)
            parent[rows[m], ru[m]] = rv[m]
        roots = parent[rows[:, None], parent]

        score_idx = np.arange(n)[None, :]
        big = np.int64(n * n + n)
        while True:
            present = np.zeros((P, n), bool)
            present[rows[:, None], roots] = True
            todo = present.sum(axis=1) > 1
            if not todo.any():
                break
            first = present.argmax(axis=1)
            p2 = present.copy()
            p2[rows, first] = False
            second = p2.argmax(axis=1)
            score = deg * n + score_idx     # orders by (degree, index)
            a = np.where(roots == first[:, None], score, big).argmin(axis=1)
            b = np.where(roots == second[:, None], score, big).argmin(axis=1)
            u = np.minimum(a, b)
            v = np.maximum(a, b)
            g = u * (2 * n - u - 1) // 2 + (v - u - 1)
            t = rows[todo]
            bits[t, g[todo]] = 1
            deg[t, u[todo]] += 1
            deg[t, v[todo]] += 1
            roots = np.where(todo[:, None] & (roots == second[:, None]),
                             first[:, None], roots)
        return bits

    def _repair_one(self, bits: np.ndarray) -> np.ndarray:
        """Sequential single-genome reference for ``repair`` (the oracle the
        vectorized path is tested against)."""
        n, maxd = self.n_chiplets, self.max_degree
        bits = bits.copy()
        deg = np.zeros(n, np.int64)
        set_idx = np.nonzero(bits)[0]
        np.add.at(deg, self.pair_u[set_idx], 1)
        np.add.at(deg, self.pair_v[set_idx], 1)
        # 1. degree cap, dropping from the highest pair index down
        for g in set_idx[::-1]:
            u, v = self.pair_u[g], self.pair_v[g]
            if deg[u] > maxd or deg[v] > maxd:
                bits[g] = 0
                deg[u] -= 1
                deg[v] -= 1
        # 2. connectivity via union-find over the surviving links
        parent = np.arange(n)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for g in np.nonzero(bits)[0]:
            ru, rv = find(self.pair_u[g]), find(self.pair_v[g])
            if ru != rv:
                parent[ru] = rv
        # repro-lint: allow[axis-loop] sequential reference oracle (vectorized twin in repair())
        roots = np.asarray([find(i) for i in range(n)])
        comp_ids = np.unique(roots)
        while len(comp_ids) > 1:
            # connect the two lexicographically-first components at their
            # minimum-degree chiplets (deterministic, no RNG)
            members_a = np.nonzero(roots == comp_ids[0])[0]
            members_b = np.nonzero(roots == comp_ids[1])[0]
            a = members_a[np.argmin(deg[members_a])]
            b = members_b[np.argmin(deg[members_b])]
            u, v = (a, b) if a < b else (b, a)
            g = self._pair_index(u, v)
            bits[g] = 1
            deg[u] += 1
            deg[v] += 1
            roots[members_b] = comp_ids[0]
            comp_ids = np.unique(roots)
        return bits

    def _pair_index(self, u: int, v: int) -> int:
        """Index of pair (u, v), u < v, in the upper-triangular flattening."""
        n = self.n_chiplets
        return int(u * (2 * n - u - 1) // 2 + (v - u - 1))

    def edges_of(self, bits: np.ndarray) -> tuple:
        set_idx = np.nonzero(np.asarray(bits, np.int64))[0]
        return tuple((int(self.pair_u[g]), int(self.pair_v[g]))
                     for g in set_idx)

    def decode_one(self, genome: np.ndarray, index: int) -> DesignPoint:
        return DesignPoint(
            index=index, topology="custom", n_chiplets=self.n_chiplets,
            traffic_pattern=self.traffic_pattern, routing=self.routing,
            seed=self.seed, shg_bits=0, packaging=self.packaging,
            technology=self.technology, links=self.edges_of(genome))
