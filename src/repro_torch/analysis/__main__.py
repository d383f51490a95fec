# Port of src/repro/analysis/__main__.py: the same CLI, with --device.
"""CLI for the port's static-analysis gate.

    python -m repro_torch.analysis --check            # lint + contract audit
    python -m repro_torch.analysis --lint             # AST lint only (fast)
    python -m repro_torch.analysis --audit            # contract audit only
    python -m repro_torch.analysis --env              # the env-knob table
    python -m repro_torch.analysis --list             # rules + programs
    python -m repro_torch.analysis --json out.json    # findings as JSON
    python -m repro_torch.analysis --write-baseline   # accept findings

The audit runs its programs on the card (``--device cuda``, the default,
as every entry point of the port; it raises where there is none) or on the
host (``--device cpu``, the plain forms). Exit status is the number of
unsuppressed findings (0 = gate passes), capped at 125 so large counts
stay distinguishable from shell errors.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from .findings import (BASELINE_PATH, apply_baseline, format_findings,
                       load_baseline, write_baseline)


def _collect(lint: bool, audit: bool, device=None):
    findings = []
    if lint:
        from .lint import lint_paths

        findings += lint_paths()
    if audit:
        from ..utils.device import resolve_device
        from .graph_audit import audit_all
        from .registry import contracts

        findings += audit_all(list(contracts()), resolve_device(device))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="run both analysis levels (the CI gate)")
    ap.add_argument("--lint", action="store_true",
                    help="AST repo lint only")
    ap.add_argument("--audit", action="store_true",
                    help="recorded-program contract audit only")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="device the audit runs on (default cuda)")
    ap.add_argument("--env", action="store_true",
                    help="print the REPRO_* env-knob registry table")
    ap.add_argument("--list", action="store_true",
                    help="list lint rules and audited programs")
    ap.add_argument("--json", metavar="PATH",
                    help="also write findings as JSON")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the committed baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help=f"accept current findings into {BASELINE_PATH.name}")
    args = ap.parse_args(argv)

    if args.env:
        from ..utils import env

        # repro-lint: allow[no-print] the analysis CLI reports to stdout regardless of REPRO_LOG
        print(env.format_table())
        return 0

    if args.list:
        from .lint import RULES
        from .registry import contracts

        # repro-lint: allow[no-print] the analysis CLI reports to stdout regardless of REPRO_LOG
        print("lint rules:")
        for rule, doc in RULES.items():
            # repro-lint: allow[no-print] the analysis CLI reports to stdout regardless of REPRO_LOG
            print(f"  {rule:20s} {doc}")
        # repro-lint: allow[no-print] the analysis CLI reports to stdout regardless of REPRO_LOG
        print("audited programs:")
        for c in contracts():
            # repro-lint: allow[no-print] the analysis CLI reports to stdout regardless of REPRO_LOG
            print(f"  {c.name:48s} {', '.join(c.checks())}")
        return 0

    lint = args.lint or args.check or not (args.lint or args.audit)
    audit = args.audit or args.check or not (args.lint or args.audit)

    findings = _collect(lint, audit, args.device)
    if args.write_baseline:
        n = write_baseline(findings)
        # repro-lint: allow[no-print] the analysis CLI reports to stdout regardless of REPRO_LOG
        print(f"baseline: {n} entries -> {BASELINE_PATH}")
        return 0
    if not args.no_baseline:
        findings = apply_baseline(findings, load_baseline())

    # repro-lint: allow[no-print] the analysis CLI reports to stdout regardless of REPRO_LOG
    print(format_findings(findings))
    if args.json:
        with open(args.json, "w") as f:
            json.dump([dataclasses.asdict(x) for x in findings], f, indent=1)
            f.write("\n")
    return min(len(findings), 125)


if __name__ == "__main__":
    sys.exit(main())
