# Copy of src/repro/obs/metrics.py, kept so repro_torch never imports repro.
"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

No numpy on the hot path: a counter increment is an integer/float add, a
histogram observation is one ``bisect`` into a precomputed geometric bucket
ladder. Percentiles (p50/p90/p99) come from the bucket counts — accurate to
one bucket width (the default ladder grows by 1.25x per bucket, so the
estimate is within ~25% relative error; tests bound it against a numpy
reference). Exact count/sum/min/max are tracked alongside.

Metrics are labelled: ``counter("ops.apsp.dispatch", backend="xla")`` and
``counter("ops.apsp.dispatch", backend="pallas")`` are distinct series.
Everything lives in the module-level ``REGISTRY``; ``snapshot()`` returns a
JSON-ready dump the report layer consumes, ``reset()`` clears it (tests,
benchmark phases).
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_right


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic accumulator (int or float increments)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, amount=1) -> None:
        # GIL-atomic enough for telemetry: a lost increment under extreme
        # contention skews a count, never corrupts state
        self.value += amount

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = None

    def set(self, value) -> None:
        self.value = value

    def reset(self) -> None:
        self.value = None


def default_buckets(lo: float = 1e-7, hi: float = 1e4,
                    factor: float = 1.25) -> tuple:
    """Geometric bucket upper bounds covering [lo, hi] — wide enough for
    sub-us span latencies and thousands-of-evals/s rates alike."""
    bounds = []
    b = lo
    while b < hi:
        bounds.append(b)
        b *= factor
    bounds.append(hi)
    return tuple(bounds)


_DEFAULT_BUCKETS = default_buckets()


class Histogram:
    """Fixed-bucket histogram with percentile estimates.

    ``bounds[i]`` is the inclusive upper edge of bucket i; one overflow
    bucket catches everything above ``bounds[-1]``.
    """

    __slots__ = ("name", "labels", "bounds", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, labels: dict, bounds: tuple | None = None):
        self.name = name
        self.labels = labels
        self.bounds = bounds if bounds is not None else _DEFAULT_BUCKETS
        self.reset()

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        self.counts[bisect_right(self.bounds, value)] += 1
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def percentile(self, q: float) -> float | None:
        """Bucket-resolution estimate of the q-th percentile (q in [0,100]):
        the upper edge of the first bucket whose cumulative count reaches
        rank ceil(q/100 * count), clamped to the exact observed min/max."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                edge = (self.bounds[i] if i < len(self.bounds)
                        else self.max)
                return min(max(edge, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "mean": self.mean,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class Registry:
    """Get-or-create store for every metric series in the process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, labels, **kw)
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: tuple | None = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def reset(self) -> None:
        """Zero every series **in place**: instrumentation sites cache
        metric objects at module level (e.g. the structure-cache counters),
        so discarding the objects would silently disconnect them."""
        with self._lock:
            for m in self._metrics.values():
                m.reset()

    def series(self, kind: str | None = None, name: str | None = None):
        """All metric objects, optionally filtered by kind ('Counter',
        'Gauge', 'Histogram') and exact series name."""
        with self._lock:
            items = list(self._metrics.items())
        for (cls_name, m_name, _), m in items:
            if kind is not None and cls_name != kind:
                continue
            if name is not None and m_name != name:
                continue
            yield m

    def snapshot(self) -> dict:
        """JSON-ready dump: lists of {name, labels, ...} per metric kind."""
        out = {"counters": [], "gauges": [], "histograms": []}
        with self._lock:
            items = list(self._metrics.items())
        for (cls_name, _, _), m in items:
            if cls_name == "Counter":
                out["counters"].append(
                    {"name": m.name, "labels": m.labels, "value": m.value})
            elif cls_name == "Gauge":
                out["gauges"].append(
                    {"name": m.name, "labels": m.labels, "value": m.value})
            else:
                out["histograms"].append(
                    {"name": m.name, "labels": m.labels, **m.to_dict()})
        for key in out:
            out[key].sort(key=lambda r: (r["name"], sorted(r["labels"].items())))
        return out


REGISTRY = Registry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, bounds: tuple | None = None, **labels) -> Histogram:
    return REGISTRY.histogram(name, bounds=bounds, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
