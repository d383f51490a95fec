# Port of src/repro/analysis/__init__.py: the gate over the port's programs.
"""Static analysis for the port (``python -m repro_torch.analysis``).

Two levels, one gate (``--check``):

* **Level 1 — contract audit** (:mod:`.graph_audit`, :mod:`.registry`):
  every performance-critical program of the port is registered with the
  shapes it runs at and the structural contract its recorded aten ops
  must satisfy — forbidden ops (no scatter in load propagation or the
  genome pipelines), no float64 on the device path, transient-size bounds
  (no ``[P, n, n]`` stack in repair, tile slabs bounded), index widths
  (every table gather indexed by >= 32-bit integers), and one program per
  shape bucket over each bucket ladder. On the card each contract's
  kernels must launch.

* **Level 2 — AST lint** (:mod:`.lint`) of ``src/repro_torch``: no
  ``print()`` outside ``obs/log.py``, no wall-clock ``time.time()``, no
  ``numpy.random`` on the device path, every ``REPRO_*`` environment read
  through :mod:`repro_torch.utils.env`, and no Python for-loops over
  population/destination axes in hot modules.

Both levels emit :class:`.findings.Finding` records, honour inline
suppressions (``# repro-lint: allow[rule-id] reason``) and the port's own
baseline (``src/repro_torch/analysis/baseline.json``).
"""
from .findings import Finding, format_findings, load_baseline
from .graph_audit import (Contract, audit_all, audit_contract, program_key,
                          record)

__all__ = ["Finding", "format_findings", "load_baseline",
           "Contract", "audit_all", "audit_contract", "program_key", "record"]
