# Copy of src/repro/obs/report.py, kept so repro_torch never imports repro.
"""Turn a run's trace + metrics dump into a report.

``summarize`` produces one machine-readable dict with two sections:

* ``spans`` — per-span-name aggregates (count, total, p50/p99) computed
  exactly from the trace events;
* ``telemetry`` — the derived health numbers the benchmarks and CI gates
  consume: async overlap %, structure-cache hit rate, jit compile counts,
  per-backend kernel dispatch counts, per-generation evals/s and p99 step
  latency. This is the ``telemetry`` block committed into BENCH_opt.json.

``format_report`` renders the human table; ``dump_run`` exports everything
a finished run has to say (JSONL trace, Chrome/Perfetto trace, metrics
snapshot, report JSON) under one path prefix; ``validate_trace`` is the
schema check behind ``python -m repro_torch.obs --check``.
"""
from __future__ import annotations

import json
import math

from .metrics import REGISTRY
from .trace import TRACER

TRACE_SCHEMA = {
    "name": str, "ts_us": (int, float), "dur_us": (int, float),
    "tid": int, "thread": str, "depth": int,
}


def load_trace(path: str) -> list[dict]:
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def validate_trace(events: list[dict], max_errors: int = 20) -> list[str]:
    """Schema errors (empty list == valid). Checks the JSONL span schema:
    required typed fields, non-negative timestamps/durations/depths, and
    attrs (when present) being a JSON object."""
    errors: list[str] = []

    def err(msg):
        if len(errors) < max_errors:
            errors.append(msg)

    if not events:
        err("trace contains no spans")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            err(f"event {i}: not an object")
            continue
        for field, types in TRACE_SCHEMA.items():
            if field not in e:
                err(f"event {i} ({e.get('name', '?')}): missing {field!r}")
            elif not isinstance(e[field], types):
                err(f"event {i} ({e.get('name', '?')}): {field!r} has type "
                    f"{type(e[field]).__name__}")
        for field in ("ts_us", "dur_us", "depth"):
            v = e.get(field)
            if isinstance(v, (int, float)) and (v < 0 or not math.isfinite(v)):
                err(f"event {i} ({e.get('name', '?')}): {field}={v}")
        if "attrs" in e and not isinstance(e["attrs"], dict):
            err(f"event {i} ({e.get('name', '?')}): attrs is not an object")
    return errors


def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return math.nan
    rank = max(1, math.ceil(q / 100.0 * len(sorted_vals)))
    return sorted_vals[rank - 1]


def span_stats(events: list[dict]) -> dict:
    """Exact per-name aggregates from trace events (host-side, tiny)."""
    by_name: dict[str, list[float]] = {}
    threads: dict[str, set] = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e["dur_us"] / 1e6)
        threads.setdefault(e["name"], set()).add(e["thread"])
    out = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        out[name] = {
            "count": len(durs),
            "total_s": round(sum(durs), 6),
            "mean_s": round(sum(durs) / len(durs), 6),
            "p50_s": round(_pct(durs, 50), 6),
            "p99_s": round(_pct(durs, 99), 6),
            "max_s": round(durs[-1], 6),
            "threads": sorted(threads[name]),
        }
    return out


def _counters(snapshot: dict, name: str) -> list[dict]:
    return [c for c in snapshot.get("counters", []) if c["name"] == name]


def _counter_value(snapshot: dict, name: str) -> float:
    return sum(c["value"] for c in _counters(snapshot, name))


def _histogram(snapshot: dict, name: str) -> dict | None:
    for h in snapshot.get("histograms", []):
        if h["name"] == name:
            return h
    return None


def _label_str(labels: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items())) or "-"


def telemetry(snapshot: dict) -> dict:
    """The derived health block (see module docstring) from one metrics
    snapshot. Every subsection degrades to zeros/None when its layer did
    not run (e.g. no structure-cache traffic on the fused device path)."""
    # -- async overlap: host work done while a device call was in flight
    host_s = _counter_value(snapshot, "opt.async.host_s")
    wait_s = _counter_value(snapshot, "opt.async.wait_s")
    overlap = (100.0 * host_s / (host_s + wait_s)
               if host_s + wait_s > 0 else None)

    # -- structure cache
    hits = _counter_value(snapshot, "structure_cache.hit")
    misses = _counter_value(snapshot, "structure_cache.miss")
    hit_rate = hits / (hits + misses) if hits + misses > 0 else None

    # -- jit compiles per bucket shape (the generalized COMPILE_COUNTS);
    # zero-valued series (registered but untouched since the last reset)
    # are dropped from the report
    compiles = {_label_str(c["labels"]): c["value"]
                for c in _counters(snapshot, "jit.compile") if c["value"]}

    # -- kernel dispatch decisions by backend/tile
    dispatch = {}
    for op in ("load_propagate", "apsp"):
        rows = {_label_str(c["labels"]): c["value"]
                for c in _counters(snapshot, f"ops.{op}.dispatch")
                if c["value"]}
        if rows:
            dispatch[op] = rows

    gen_s = _histogram(snapshot, "opt.generation_s")
    evals_ps = _histogram(snapshot, "opt.evals_per_s")
    ingest_s = _histogram(snapshot, "opt.ingest_s")

    return {
        "async_overlap_pct": (round(overlap, 2)
                              if overlap is not None else None),
        "async_host_hidden_s": round(host_s, 4),
        "async_device_wait_s": round(wait_s, 4),
        "structure_cache": {"hits": int(hits), "misses": int(misses),
                            "hit_rate": (round(hit_rate, 4)
                                         if hit_rate is not None else None)},
        "jit_compiles": {"total": int(sum(compiles.values())),
                         "by_shape": compiles},
        "kernel_dispatch": dispatch,
        "generations": ({"count": gen_s["count"],
                         "p50_s": gen_s["p50"], "p99_s": gen_s["p99"],
                         "max_s": gen_s["max"]} if gen_s else None),
        "evals_per_s": ({"p50": evals_ps["p50"], "p99": evals_ps["p99"],
                         "min": evals_ps["min"], "max": evals_ps["max"]}
                        if evals_ps else None),
        "host_ingest": ({"count": ingest_s["count"], "p50_s": ingest_s["p50"],
                         "p99_s": ingest_s["p99"],
                         "total_s": round(ingest_s["sum"], 4)}
                        if ingest_s else None),
    }


def summarize(events: list[dict], snapshot: dict) -> dict:
    """Machine-readable report from a trace + metrics snapshot."""
    threads = sorted({e["thread"] for e in events})
    dur = (max((e["ts_us"] + e["dur_us"] for e in events), default=0.0)
           - min((e["ts_us"] for e in events), default=0.0))
    return {
        "trace": {"n_spans": len(events), "threads": threads,
                  "duration_s": round(dur / 1e6, 4)},
        "spans": span_stats(events),
        "telemetry": telemetry(snapshot),
    }


def _fmt_row(cols, widths):
    return "  ".join(str(c).ljust(w) for c, w in zip(cols, widths)).rstrip()


def format_report(summary: dict) -> str:
    """Human-readable summary table of a run (see README 'Observing a
    run')."""
    t = summary["telemetry"]
    tr = summary["trace"]
    lines = [
        "== repro_torch.obs run report ==",
        f"trace: {tr['n_spans']} spans over {tr['duration_s']}s on "
        f"{len(tr['threads'])} thread(s): {', '.join(tr['threads'])}",
        "",
        "-- telemetry --",
    ]
    ov = t["async_overlap_pct"]
    lines.append(f"async overlap:        "
                 + (f"{ov}% of host bookkeeping hidden under in-flight "
                    f"device calls (host {t['async_host_hidden_s']}s, "
                    f"wait {t['async_device_wait_s']}s)"
                    if ov is not None else "n/a (no async driver activity)"))
    sc = t["structure_cache"]
    lines.append(f"structure cache:      "
                 + (f"{sc['hit_rate'] * 100:.1f}% hit rate "
                    f"({sc['hits']} hits / {sc['misses']} misses)"
                    if sc["hit_rate"] is not None
                    else f"no lookups (fused device path bypasses it)"))
    jc = t["jit_compiles"]
    lines.append(f"jit compiles:         {jc['total']} "
                 f"across {len(jc['by_shape'])} program shape(s)")
    for key, v in sorted(jc["by_shape"].items()):
        lines.append(f"    {key}: {v}")
    if t["kernel_dispatch"]:
        lines.append("kernel dispatch:")
        for op, rows in sorted(t["kernel_dispatch"].items()):
            for key, v in sorted(rows.items()):
                lines.append(f"    {op}[{key}]: {v}")
    else:
        lines.append("kernel dispatch:      none recorded")
    if t["generations"]:
        g = t["generations"]
        lines.append(f"generation latency:   p50 {g['p50_s']:.4g}s  "
                     f"p99 {g['p99_s']:.4g}s  over {g['count']} generations")
    if t["evals_per_s"]:
        e = t["evals_per_s"]
        lines.append(f"evals/s:              p50 {e['p50']:.4g}  "
                     f"worst {e['min']:.4g}  best {e['max']:.4g}")
    lines += ["", "-- spans --"]
    header = ("span", "count", "total_s", "p50_s", "p99_s", "threads")
    rows = [header]
    for name, s in sorted(summary["spans"].items(),
                          key=lambda kv: -kv[1]["total_s"]):
        rows.append((name, s["count"], f"{s['total_s']:.4f}",
                     f"{s['p50_s']:.5f}", f"{s['p99_s']:.5f}",
                     ",".join(s["threads"])))
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(header))]
    lines += [_fmt_row(r, widths) for r in rows]
    return "\n".join(lines)


def dump_run(prefix: str, tracer=None, registry=None) -> dict:
    """Export everything a traced run has to say under one path prefix:

        <prefix>.trace.jsonl    span-per-line trace (the validated schema)
        <prefix>.chrome.json    chrome://tracing / Perfetto trace
        <prefix>.metrics.json   raw metrics snapshot
        <prefix>.report.json    summarize(...) output (telemetry block)

    Returns the summary dict."""
    tracer = tracer if tracer is not None else TRACER
    registry = registry if registry is not None else REGISTRY
    tracer.export_jsonl(prefix + ".trace.jsonl")
    tracer.export_chrome(prefix + ".chrome.json")
    snapshot = registry.snapshot()
    with open(prefix + ".metrics.json", "w") as f:
        json.dump(snapshot, f, indent=2, default=str)
        f.write("\n")
    summary = summarize(tracer.to_dicts(), snapshot)
    with open(prefix + ".report.json", "w") as f:
        json.dump(summary, f, indent=2, default=str)
        f.write("\n")
    return summary
