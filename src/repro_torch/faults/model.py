# Copy of src/repro/faults/model.py, kept so repro_torch never imports repro.
"""Seeded, vectorized fault-scenario samplers.

A *fault scenario* is one hypothetical runtime failure state of a
manufactured design: a set of dead links plus a set of dead chiplets.
Scenarios are batched — every sampler returns a ``FaultScenarios`` bundle
with a ``[F, n_links]`` link-failure mask, a ``[F, n]`` chiplet-failure
mask, and per-scenario probability weights — and applied as pure mask
transforms on the adjacency/structure arrays by the fused device grid
(``dse.genomes.evaluate_faults_async``): a dead link vanishes from the
adjacency, a dead chiplet loses every incident link and stops sourcing or
sinking traffic, and the degraded routing tables are recomputed under the
mask.

Link-failure masks index the genome's upper-triangle pair slots of
``opt.space.AdjacencySpace`` (``pair_u``/``pair_v``); a scenario masks a
pair *slot*, so it applies uniformly across a population (the slot is a
no-op for genomes that never had the link). Three model families:

* ``iid_link_faults`` — independent per-link failures at probability
  ``p`` (BER-style marginal PHY model);
* ``region_faults`` — spatially correlated interposer-region faults:
  every link whose grid midpoint falls inside a randomly-centered square
  region fails together (cracks, voids, local delamination);
* ``single_link_faults`` / ``double_link_faults`` /
  ``single_chiplet_faults`` — exhaustive (or top-k by grid length)
  enumeration for worst-case-over-failures objectives.

All samplers are seeded (``np.random.default_rng``) and prepend the
pristine all-alive scenario by default (``include_pristine=True``), so
scenario 0 of the grid reproduces the pristine metrics and worst-case
reductions never beat the undamaged design.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class FaultScenarios:
    """A batch of fault scenarios for one adjacency space."""
    link_fail: np.ndarray        # [F, G] bool, True = link slot failed
    node_fail: np.ndarray        # [F, n] bool, True = chiplet dead
    weights: np.ndarray          # [F] f64 probability weights (sum 1)
    names: tuple[str, ...]       # scenario labels (diagnostics)
    kind: str = "custom"

    @property
    def n_scenarios(self) -> int:
        return len(self.link_fail)

    def __post_init__(self):
        F, _ = self.link_fail.shape
        if self.node_fail.shape[0] != F or len(self.weights) != F \
                or len(self.names) != F:
            raise ValueError("scenario axis mismatch between link_fail/"
                             "node_fail/weights/names")


def _grid_layout(n: int):
    from ..topologies.grid import grid_dims
    rows, cols = grid_dims(n)
    col_of = np.arange(n) % cols
    row_of = np.arange(n) // cols
    return rows, cols, col_of, row_of


def _finalize(space, link_fail, node_fail, names, kind,
              include_pristine: bool, weights=None) -> FaultScenarios:
    G = space.genome_length
    n = space.n_chiplets
    link_fail = np.asarray(link_fail, bool).reshape(-1, G)
    node_fail = np.asarray(node_fail, bool).reshape(-1, n)
    names = list(names)
    if weights is None:
        weights = np.full(len(link_fail), 1.0, np.float64)
    weights = np.asarray(weights, np.float64)
    if include_pristine:
        link_fail = np.concatenate(
            [np.zeros((1, G), bool), link_fail], axis=0)
        node_fail = np.concatenate(
            [np.zeros((1, n), bool), node_fail], axis=0)
        names = ["pristine"] + names
        weights = np.concatenate([[weights.mean() if len(weights) else 1.0],
                                  weights])
    weights = weights / max(weights.sum(), 1e-30)
    return FaultScenarios(link_fail=link_fail, node_fail=node_fail,
                          weights=weights, names=tuple(names), kind=kind)


def iid_link_faults(space, p: float = 0.02, n_scenarios: int = 16,
                    seed: int = 0,
                    include_pristine: bool = True) -> FaultScenarios:
    """Independent per-link failures: each of the G pair slots fails with
    probability ``p`` in each sampled scenario (BER-style marginal model
    of marginal PHYs / lane loss)."""
    rng = np.random.default_rng(seed)
    G = space.genome_length
    link_fail = rng.random((n_scenarios, G)) < p
    node_fail = np.zeros((n_scenarios, space.n_chiplets), bool)
    names = [f"iid[p={p:g}]#{i}" for i in range(n_scenarios)]
    return _finalize(space, link_fail, node_fail, names, "iid",
                     include_pristine)


def region_faults(space, radius: float = 0.75, n_scenarios: int = 16,
                  seed: int = 0,
                  include_pristine: bool = True) -> FaultScenarios:
    """Spatially correlated interposer-region faults: a random center on
    the placement grid takes down every link whose grid midpoint lies
    within Chebyshev distance ``radius`` (interposer cracks / voids kill
    *clusters* of adjacent links, the failure mode i.i.d. models miss)."""
    rng = np.random.default_rng(seed)
    n = space.n_chiplets
    rows, cols, col_of, row_of = _grid_layout(n)
    pu, pv = space.pair_u, space.pair_v
    mid_c = (col_of[pu] + col_of[pv]) / 2.0                      # [G]
    mid_r = (row_of[pu] + row_of[pv]) / 2.0
    cc = rng.uniform(0.0, cols - 1.0, n_scenarios)
    cr = rng.uniform(0.0, rows - 1.0, n_scenarios)
    link_fail = ((np.abs(mid_c[None, :] - cc[:, None]) <= radius)
                 & (np.abs(mid_r[None, :] - cr[:, None]) <= radius))
    node_fail = np.zeros((n_scenarios, n), bool)
    names = [f"region[r={radius:g}]@({c:.2f},{r:.2f})"
             for c, r in zip(cc, cr)]
    return _finalize(space, link_fail, node_fail, names, "region",
                     include_pristine)


def _pairs_by_length(space) -> np.ndarray:
    """Pair slots ordered by descending grid length (longest interposer
    traces first — the most exposed links), ties broken by slot index."""
    n = space.n_chiplets
    _, _, col_of, row_of = _grid_layout(n)
    pu, pv = space.pair_u, space.pair_v
    gridd = (np.abs(col_of[pu] - col_of[pv])
             + np.abs(row_of[pu] - row_of[pv]))
    return np.lexsort((np.arange(len(pu)), -gridd))


def single_link_faults(space, top_k: int | None = None,
                       include_pristine: bool = True) -> FaultScenarios:
    """Exhaustive single-link-failure enumeration: one scenario per pair
    slot (F = G), or the ``top_k`` longest-trace slots only."""
    G = space.genome_length
    order = _pairs_by_length(space)
    if top_k is not None:
        order = order[:min(top_k, G)]
    link_fail = np.zeros((len(order), G), bool)
    link_fail[np.arange(len(order)), order] = True
    node_fail = np.zeros((len(order), space.n_chiplets), bool)
    names = [f"link[{int(g)}]" for g in order]
    return _finalize(space, link_fail, node_fail, names, "single",
                     include_pristine)


def double_link_faults(space, top_k: int = 12,
                       include_pristine: bool = True) -> FaultScenarios:
    """Double-failure enumeration over the ``top_k`` longest-trace slots:
    one scenario per unordered pair of candidate links (F = C(top_k, 2))."""
    G = space.genome_length
    cand = _pairs_by_length(space)[:min(top_k, G)]
    ii, jj = np.triu_indices(len(cand), k=1)
    link_fail = np.zeros((len(ii), G), bool)
    link_fail[np.arange(len(ii)), cand[ii]] = True
    link_fail[np.arange(len(jj)), cand[jj]] = True
    node_fail = np.zeros((len(ii), space.n_chiplets), bool)
    names = [f"link2[{int(cand[i])},{int(cand[j])}]"
             for i, j in zip(ii, jj)]
    return _finalize(space, link_fail, node_fail, names, "double",
                     include_pristine)


def single_chiplet_faults(space,
                          include_pristine: bool = True) -> FaultScenarios:
    """Exhaustive single-chiplet-failure enumeration (F = n): a dead
    chiplet loses every incident link, relays nothing, and neither sources
    nor sinks traffic."""
    n = space.n_chiplets
    node_fail = np.eye(n, dtype=bool)
    link_fail = np.zeros((n, space.genome_length), bool)
    names = [f"chiplet[{c}]" for c in range(n)]
    return _finalize(space, link_fail, node_fail, names, "chiplet",
                     include_pristine)


MODELS = {
    "iid": iid_link_faults,
    "region": region_faults,
    "single": single_link_faults,
    "double": double_link_faults,
    "chiplet": single_chiplet_faults,
}


def make_scenarios(space, model: str, **kwargs) -> FaultScenarios:
    """Factory over the registered fault models (``--fault-model`` CLI)."""
    try:
        fn = MODELS[model]
    except KeyError:
        raise ValueError(f"unknown fault model {model!r}; options: "
                         f"{sorted(MODELS)}") from None
    return fn(space, **kwargs)


__all__ = ["FaultScenarios", "MODELS", "make_scenarios", "iid_link_faults",
           "region_faults", "single_link_faults", "double_link_faults",
           "single_chiplet_faults"]
