# Frozen copy of src/repro/faults/model.py's iid_link_faults (with _finalize's pristine scenario).
"""Independent per-link failures: each of the G pair slots fails with
probability ``p`` in each sampled scenario; scenario 0 is the pristine
all-alive one. Returns the [F, G] link-failure and [F, n] chiplet-failure
masks (no chiplet fails under this model)."""
from __future__ import annotations

import numpy as np


def iid_link_faults(genome_length: int, n_chiplets: int, p: float,
                    n_scenarios: int, rng: np.random.Generator
                    ) -> tuple[np.ndarray, np.ndarray]:
    """``n_scenarios`` sampled scenarios after the pristine one, so the
    masks have ``n_scenarios + 1`` rows."""
    link_fail = rng.random((n_scenarios, genome_length)) < p
    node_fail = np.zeros((n_scenarios, n_chiplets), bool)
    link_fail = np.concatenate(
        [np.zeros((1, genome_length), bool), link_fail], axis=0)
    node_fail = np.concatenate(
        [np.zeros((1, n_chiplets), bool), node_fail], axis=0)
    return link_fail, node_fail
