# Copy of src/repro/obs/__main__.py, kept so repro_torch never imports repro.
"""CLI over a run's observability dump.

    # after `python -m repro_torch.opt ... --trace opt_trace`
    python -m repro_torch.obs --prefix opt_trace            # print the report
    python -m repro_torch.obs --prefix opt_trace --check    # validate the trace
    python -m repro_torch.obs --prefix obs_smoke --check \
        --bench BENCH_opt_smoke.json --max-overhead-pct 3   # the CI gate

``--check`` validates the JSONL trace schema; with ``--bench`` it also
enforces the tracing-overhead bound recorded by
``benchmarks/opt_convergence.py`` (the ``telemetry.trace_overhead_pct``
field must exist and stay within ``--max-overhead-pct``).
"""
from __future__ import annotations

import argparse
import json
import os

from .log import get_logger
from .report import format_report, load_trace, summarize, validate_trace

_LOG = get_logger("obs")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize, validate, and gate a traced run's "
                    "observability dump.")
    p.add_argument("--prefix", type=str, default="opt_trace",
                   help="path prefix used by the run's dump "
                        "(reads <prefix>.trace.jsonl, <prefix>.metrics.json)")
    p.add_argument("--trace", type=str, default=None,
                   help="explicit trace JSONL path (overrides --prefix)")
    p.add_argument("--metrics", type=str, default=None,
                   help="explicit metrics snapshot path (overrides --prefix)")
    p.add_argument("--json", type=str, default=None,
                   help="write the machine-readable summary here")
    p.add_argument("--check", action="store_true",
                   help="validate the trace schema (exit 1 on errors); with "
                        "--bench also gate the recorded tracing overhead")
    p.add_argument("--bench", type=str, default=None,
                   help="BENCH_opt*.json whose telemetry.trace_overhead_pct "
                        "the --check gate enforces")
    p.add_argument("--max-overhead-pct", type=float, default=3.0,
                   help="fail --check when the benchmark's recorded full-"
                        "tracing overhead exceeds this (default 3%%)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the report body (checks still print)")
    args = p.parse_args(argv)

    trace_path = args.trace or args.prefix + ".trace.jsonl"
    metrics_path = args.metrics or args.prefix + ".metrics.json"
    events = load_trace(trace_path)
    snapshot = {"counters": [], "gauges": [], "histograms": []}
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            snapshot = json.load(f)
    summary = summarize(events, snapshot)
    if not args.quiet:
        _LOG.info(format_report(summary))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, default=str)
            f.write("\n")

    if not args.check:
        return 0

    ok = True
    errors = validate_trace(events)
    if errors:
        ok = False
        _LOG.error(f"TRACE SCHEMA: {len(errors)} error(s) in {trace_path}:")
        for e in errors:
            _LOG.error(f"  {e}")
    else:
        _LOG.info(f"trace schema OK: {len(events)} spans in {trace_path}")

    if args.bench:
        with open(args.bench) as f:
            bench = json.load(f)
        overhead = (bench.get("telemetry") or {}).get("trace_overhead_pct")
        if overhead is None:
            ok = False
            _LOG.error(f"OVERHEAD GATE: {args.bench} has no "
                       f"telemetry.trace_overhead_pct field")
        elif overhead > args.max_overhead_pct:
            ok = False
            _LOG.error(f"OVERHEAD GATE: full tracing costs {overhead}% "
                       f"(> {args.max_overhead_pct}% bound)")
        else:
            _LOG.info(f"overhead gate OK: full tracing costs {overhead}% "
                      f"(<= {args.max_overhead_pct}%)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
