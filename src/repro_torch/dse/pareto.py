# Copy of src/repro/dse/pareto.py, kept so repro_torch never imports repro.
"""Latency-throughput Pareto fronts under area constraints (paper §4.2).

The dominance/front computation lives in ``opt.archive`` — the
multi-objective archive the optimizers maintain — and is re-exported here so
the sweep-side API is the reference's.
"""
from __future__ import annotations

from ..opt.archive import hypervolume_2d, pareto_front

__all__ = ["pareto_front", "hypervolume_2d"]
