# Copy of src/repro/faults/objectives.py, kept so repro_torch never imports repro.
"""Robust Pareto objectives over a [P, F] fault grid.

``reduce_grid`` folds the population x scenario metric grid produced by
``dse.genomes.evaluate_faults_async`` into per-genome robustness columns:

* ``expected_latency`` / ``expected_throughput`` — scenario-weighted
  means (weights from the fault model, normalized);
* ``worst_latency`` / ``worst_throughput`` — worst case over F (max
  latency, min throughput) — the objective that makes NSGA-II prefer
  graceful degradation over a slightly-faster glass cannon;
* ``disconnect_prob`` — probability mass of scenarios that disconnect
  any traffic (reachable fraction < 1), the constraint column;
* ``min_reachable_fraction`` — worst delivered-traffic share.

``RobustObjectives`` picks which pair replaces the pristine
latency/throughput as the archive's Pareto axes (``mode``), and which
designs the disconnection constraint rejects (``max_disconnect_prob``).
Scenario 0 is the pristine design when the fault model was built with
``include_pristine=True`` (the default), so worst-case columns are
never better than the undamaged metrics and the pristine metrics ride
along for reporting.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

REACH_EPS = 1e-6


@dataclass(frozen=True)
class RobustObjectives:
    """Configuration of the fault-aware optimization mode."""
    mode: str = "worst"                 # "worst" | "expected"
    max_disconnect_prob: float = 0.0    # feasibility: P[disconnect] <= this

    def __post_init__(self):
        if self.mode not in ("worst", "expected"):
            raise ValueError(f"unknown robust mode {self.mode!r}; "
                             f"options: worst, expected")


def reduce_grid(latency: np.ndarray, throughput: np.ndarray,
                reachable_fraction: np.ndarray,
                weights: np.ndarray) -> dict[str, np.ndarray]:
    """Fold [P, F] metric grids into per-genome robustness columns [P]."""
    lat = np.asarray(latency, np.float64)
    thr = np.asarray(throughput, np.float64)
    reach = np.asarray(reachable_fraction, np.float64)
    w = np.asarray(weights, np.float64)
    w = w / max(w.sum(), 1e-30)
    disconnected = reach < (1.0 - REACH_EPS)
    return {
        "expected_latency": lat @ w,
        "expected_throughput": thr @ w,
        "worst_latency": lat.max(axis=1),
        "worst_throughput": thr.min(axis=1),
        "disconnect_prob": disconnected.astype(np.float64) @ w,
        "min_reachable_fraction": reach.min(axis=1),
    }


def robust_columns(reduced: dict[str, np.ndarray],
                   cfg: RobustObjectives
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(latency, throughput, feasible) under the configured mode: the two
    arrays that replace the pristine proxies as the archive's Pareto axes
    plus the disconnection-probability constraint mask."""
    if cfg.mode == "worst":
        lat = reduced["worst_latency"]
        thr = reduced["worst_throughput"]
    else:
        lat = reduced["expected_latency"]
        thr = reduced["expected_throughput"]
    feasible = reduced["disconnect_prob"] <= (cfg.max_disconnect_prob
                                              + 1e-12)
    return lat, thr, feasible


@dataclass(frozen=True)
class FaultSetup:
    """Everything the optimizer needs for fault-aware evaluation: the
    scenario batch (``faults.model.FaultScenarios``) plus the objective
    configuration. Passed as ``PopulationEvaluator(..., faults=...)``."""
    scenarios: object                 # FaultScenarios
    objectives: RobustObjectives = RobustObjectives()


__all__ = ["RobustObjectives", "FaultSetup", "reduce_grid",
           "robust_columns", "REACH_EPS"]
