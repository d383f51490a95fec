# Copy of src/repro/obs/trace.py, kept so repro_torch never imports repro.
"""Nestable, thread-aware spans over a bounded in-memory ring buffer.

Design constraints:

* **off-by-default-cheap** — ``span(name)`` on a disabled tracer is one
  attribute lookup plus returning a shared no-op context manager; nothing
  is allocated that outlives the call (asserted in tests/test_obs.py).
* **thread-aware** — every span records the thread it ran on, so the async
  driver's dispatch/finish overlap and the DSE engine's prefetch thread are
  visible as separate tracks in the Chrome-trace view.
* **bounded** — events land in a ring buffer (``maxlen`` events, oldest
  dropped first, drops counted), so an unbounded run cannot grow host
  memory through its own telemetry.

Export formats: JSONL (one span per line — the schema ``report.validate``
checks) and the Chrome trace-event JSON that ``chrome://tracing`` and
Perfetto (https://ui.perfetto.dev) load directly.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..utils import env as _env

# Span event tuple layout (kept a tuple, not a dataclass, for append cost):
#   (name, t0_ns, t1_ns, thread_id, thread_name, depth, attrs-dict-or-None)
_NAME, _T0, _T1, _TID, _TNAME, _DEPTH, _ATTRS = range(7)

DEFAULT_MAXLEN = 262_144


class _NullSpan:
    """Shared no-op context manager returned by every disabled ``span``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):   # parity with _Span
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict | None):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs or None

    def set(self, **attrs):
        """Attach attributes after entry (e.g. results known at exit)."""
        if self._attrs is None:
            self._attrs = {}
        self._attrs.update(attrs)
        return self

    def __enter__(self):
        local = self._tracer._local
        depth = getattr(local, "depth", 0)
        local.depth = depth + 1
        self._depth = depth
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        tracer = self._tracer
        tracer._local.depth = self._depth
        th = threading.current_thread()
        tracer._emit((self._name, self._t0, t1, th.ident, th.name,
                      self._depth, self._attrs))
        return False


class Tracer:
    """Bounded ring buffer of spans; see module docstring.

    The module-level ``TRACER`` is the process-wide instance every
    instrumentation site uses; independent ``Tracer()`` objects exist for
    tests. ``REPRO_TRACE=1`` enables the global tracer at import.
    """

    def __init__(self, maxlen: int = DEFAULT_MAXLEN, enabled: bool = False):
        self.enabled = enabled
        self.maxlen = maxlen
        self._events: deque = deque(maxlen=maxlen)
        self._local = threading.local()
        self._lock = threading.Lock()
        self.n_emitted = 0
        # monotonic origin + the wall time it corresponds to, so exported
        # timestamps are relative (t=0 at enable) but anchored for humans
        self._t0_ns = time.monotonic_ns()
        # repro-lint: allow[no-wallclock] wall-time anchor for exported trace timestamps
        self._t0_wall = time.time()

    # -- control ------------------------------------------------------------
    def enable(self, clear: bool = True) -> None:
        if clear:
            self.clear()
        self._t0_ns = time.monotonic_ns()
        # repro-lint: allow[no-wallclock] wall-time anchor for exported trace timestamps
        self._t0_wall = time.time()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.n_emitted = 0

    @property
    def n_dropped(self) -> int:
        return self.n_emitted - len(self._events)

    # -- recording ----------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager timing a nested span. When the tracer is
        disabled this is one attribute check returning a shared no-op."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def _emit(self, event: tuple) -> None:
        with self._lock:
            self._events.append(event)
            self.n_emitted += 1

    # -- export -------------------------------------------------------------
    def to_dicts(self) -> list[dict]:
        """Events as JSONL-ready dicts (timestamps in us since enable)."""
        t0 = self._t0_ns
        with self._lock:
            events = list(self._events)
        out = []
        for e in events:
            rec = {"name": e[_NAME],
                   "ts_us": (e[_T0] - t0) / 1e3,
                   "dur_us": (e[_T1] - e[_T0]) / 1e3,
                   "tid": e[_TID], "thread": e[_TNAME],
                   "depth": e[_DEPTH]}
            if e[_ATTRS]:
                rec["attrs"] = e[_ATTRS]
            out.append(rec)
        out.sort(key=lambda r: r["ts_us"])
        return out

    def export_jsonl(self, path: str) -> int:
        """One span per line; returns the number of spans written."""
        events = self.to_dicts()
        with open(path, "w") as f:
            for rec in events:
                f.write(json.dumps(rec, default=str) + "\n")
        return len(events)

    def export_chrome(self, path: str) -> int:
        """Chrome trace-event JSON (``chrome://tracing`` / Perfetto).

        Spans become complete ("ph": "X") events; per-thread metadata
        events carry thread names so the async driver's threads are
        labelled tracks in the viewer."""
        t0 = self._t0_ns
        pid = os.getpid()
        with self._lock:
            events = list(self._events)
        trace_events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": "repro"}},
        ]
        threads_seen: dict[int, str] = {}
        for e in events:
            if e[_TID] not in threads_seen:
                threads_seen[e[_TID]] = e[_TNAME]
                trace_events.append(
                    {"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": e[_TID], "args": {"name": e[_TNAME]}})
            rec = {"ph": "X", "cat": "repro", "name": e[_NAME], "pid": pid,
                   "tid": e[_TID], "ts": (e[_T0] - t0) / 1e3,
                   "dur": (e[_T1] - e[_T0]) / 1e3}
            if e[_ATTRS]:
                rec["args"] = {k: (v if isinstance(v, (int, float, str,
                                                       bool, type(None)))
                                   else str(v))
                               for k, v in e[_ATTRS].items()}
            trace_events.append(rec)
        with open(path, "w") as f:
            json.dump({"traceEvents": trace_events,
                       "displayTimeUnit": "ms",
                       "otherData": {
                           "wall_time_origin": self._t0_wall,
                           "dropped_events": self.n_dropped}},
                      f, default=str)
        return len(events)


TRACER = Tracer(enabled=_env.get_bool("REPRO_TRACE"))


def span(name: str, **attrs):
    """Module-level span on the process-wide tracer (the instrumentation
    entry point). Disabled cost: one attribute lookup + shared no-op."""
    if not TRACER.enabled:
        return _NULL_SPAN
    return _Span(TRACER, name, attrs)


def enable_tracing(clear: bool = True) -> None:
    TRACER.enable(clear=clear)


def disable_tracing() -> None:
    TRACER.disable()


def tracing_enabled() -> bool:
    return TRACER.enabled
