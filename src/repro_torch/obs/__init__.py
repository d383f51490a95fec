# Copy of src/repro/obs/__init__.py, kept so repro_torch never imports repro.
"""Observability for the search pipeline: tracing, metrics, logs.

Zero-dependency (stdlib only) and off-by-default-cheap: a disabled
``span(...)`` is one attribute lookup returning a shared no-op context
manager, and a disabled counter increment is a plain integer add — the hot
paths (``kernels.ops`` dispatch, ``core.structure_cache`` lookups, the
optimizer's generation loop) stay instrumented permanently without a
measurable tax (the ``benchmarks/opt_convergence.py`` telemetry phase
asserts full tracing costs <= 3% of untraced throughput).

Three layers:

* ``obs.trace`` — nestable, thread-aware spans in a bounded ring buffer,
  exported as JSONL or a Chrome-trace/Perfetto JSON
  (``chrome://tracing``-loadable);
* ``obs.metrics`` — a process-wide registry of counters / gauges /
  fixed-bucket histograms (p50/p99 without numpy on the hot path);
* ``obs.log`` — the single structured ``logging`` root for the repo's CLI
  output (``REPRO_LOG=debug|info|quiet``).

Enable tracing with ``REPRO_TRACE=1`` or ``obs.enable_tracing()``.
``obs.report`` loads, validates and summarizes a run's trace; its CLI is
``python -m repro_torch.obs``.
"""
from .trace import (TRACER, Tracer, disable_tracing, enable_tracing, span,
                    tracing_enabled)
from .metrics import REGISTRY, counter, gauge, histogram
from .log import get_logger

__all__ = [
    "TRACER", "Tracer", "span", "enable_tracing", "disable_tracing",
    "tracing_enabled", "REGISTRY", "counter", "gauge", "histogram",
    "get_logger",
]
