# Copy of src/repro/analysis/findings.py with the port's own baseline file.
"""Structured findings, inline suppressions, and the committed baseline.

Every analysis rule — AST lint and jaxpr contract audit alike — reports
:class:`Finding` records. Two suppression mechanisms keep the gate at
zero without hiding new regressions:

* **inline allows** — ``# repro-lint: allow[rule-id] reason`` on the
  flagged line (or the line above it) suppresses that rule at that site.
  The reason is mandatory: an allow without one is itself a finding
  (rule ``suppression-reason``), so every suppression in the tree
  documents why the exception is deliberate.
* **baseline** — ``src/repro_torch/analysis/baseline.json`` (the port's
  own; the reference keeps ``analysis_baseline.json`` at the repo root)
  lists finding keys ``(rule, path, contract)`` accepted wholesale. The
  gate starts at an empty baseline (every initial finding was fixed or
  inline-allowed); the file exists so a future bulk rule rollout can land
  incrementally.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"

# "# repro-lint: allow[rule-a,rule-b] reason text" (reason mandatory)
_ALLOW_RE = re.compile(
    r"#\s*repro-lint:\s*allow\[([A-Za-z0-9_,\s-]+)\]\s*(\S.*)?$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis violation.

    ``path`` is repo-relative (posix); ``line`` is 1-based (0 for
    whole-program findings such as contract audits); ``contract`` names
    the audited program for level-1 findings and is empty for lint.
    """

    rule: str
    path: str
    line: int
    message: str
    contract: str = ""

    def key(self) -> tuple[str, str, str]:
        """Baseline identity — line numbers excluded so unrelated edits
        above a baselined site do not resurrect it."""
        return (self.rule, self.path, self.contract)

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tag = f" [{self.contract}]" if self.contract else ""
        return f"{loc}: {self.rule}{tag}: {self.message}"


def parse_allows(lines: list[str], path: str
                 ) -> tuple[dict[int, set[str]], list[Finding]]:
    """Per-line rule allows from ``# repro-lint: allow[...] reason``
    comments; allows missing a reason are returned as findings."""
    allows: dict[int, set[str]] = {}
    bad: list[Finding] = []
    for i, text in enumerate(lines, start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        allows[i] = rules
        if not m.group(2):
            bad.append(Finding(
                rule="suppression-reason", path=path, line=i,
                message="repro-lint allow comment without a reason; "
                        "write `# repro-lint: allow[rule] why`"))
    return allows, bad


def is_suppressed(finding: Finding, allows: dict[int, set[str]]) -> bool:
    """An allow suppresses its own line and the line directly below it
    (so a standalone comment above the flagged statement works)."""
    for line in (finding.line, finding.line - 1):
        if finding.rule in allows.get(line, ()):
            return True
    return False


def load_baseline(path: Path | None = None) -> set[tuple[str, str, str]]:
    path = path or BASELINE_PATH
    if not path.exists():
        return set()
    with open(path) as f:
        entries = json.load(f)
    return {(e["rule"], e["path"], e.get("contract", "")) for e in entries}


def write_baseline(findings: list[Finding], path: Path | None = None) -> int:
    path = path or BASELINE_PATH
    entries = sorted({f.key() for f in findings})
    with open(path, "w") as f:
        json.dump([{"rule": r, "path": p, "contract": c}
                   for r, p, c in entries], f, indent=1)
        f.write("\n")
    return len(entries)


def apply_baseline(findings: list[Finding],
                   baseline: set[tuple[str, str, str]]) -> list[Finding]:
    return [f for f in findings if f.key() not in baseline]


def format_findings(findings: list[Finding]) -> str:
    if not findings:
        return "analysis: clean (0 findings)"
    lines = [f.format() for f in sorted(
        findings, key=lambda f: (f.path, f.line, f.rule))]
    lines.append(f"analysis: {len(findings)} finding(s)")
    return "\n".join(lines)
