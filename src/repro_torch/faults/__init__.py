# Port of src/repro/faults/__init__.py.
"""Fault-aware evaluation and graceful degradation.

Four submodules:

* ``faults.model`` — seeded, vectorized fault samplers: ``[F, n_links]``
  link-failure masks and ``[F, n]`` chiplet-failure masks (i.i.d. BER,
  spatially correlated interposer regions, exhaustive/top-k single- and
  double-failure enumeration).
* ``faults.objectives`` — reduce a ``[P, F]`` population x fault metric
  grid into robust Pareto objectives (expected / worst-case latency and
  throughput, disconnection probability).
* ``faults.reference`` — an independent numpy oracle for degraded
  metrics (pure-Python BFS routing + route walking) that the fault grid
  (``dse.genomes.AdjacencyPipeline.evaluate_faults_async``) is tested
  against to <= 1e-5.
* ``faults.harness`` — graceful degradation of the harness itself:
  non-finite quarantine, watchdog retries, SIGTERM-flushed checkpoints,
  snapshot digests (no kernel-backend fallback ladder: see its docstring).

Submodules load lazily, as in the reference.
"""
from __future__ import annotations

import importlib

_SUBMODULES = ("model", "objectives", "reference", "harness")


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_SUBMODULES)
