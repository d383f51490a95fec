# Port of src/repro/analysis/lint.py: the same five rules over src/repro_torch.
"""Level 2: AST-based lint of the port's tree (``src/repro_torch``; the
reference's ``src/repro`` and ``benchmarks`` are the reference's own
gate's).

Rules (ids are what inline allows and the baseline reference):

* ``no-print`` — ``print()`` anywhere under ``src/repro_torch`` except
  ``obs/log.py``: all user-facing output goes through the structured
  logging root so ``REPRO_LOG`` controls it.
* ``no-wallclock`` — ``time.time()`` under ``src/repro_torch``: durations use
  ``time.perf_counter``/``monotonic`` or ``obs.trace`` spans; the only
  wall-clock sites are the trace exporter's origin anchors (inline
  allowed there).
* ``no-np-random`` — ``numpy.random`` in device-path modules: device
  results must be a function of their inputs, not host RNG state.
* ``env-read`` — raw ``os.environ``/``os.getenv`` reads of ``REPRO_*``
  keys anywhere under ``src/repro_torch``, and registry reads
  (``env.get_int("REPRO_...")`` and the like) of a key that
  :mod:`repro_torch.utils.env` does not register: every knob goes through
  that registry so ``--env`` can print a complete table and typos fail
  loudly.
* ``axis-loop`` — ``for _ in range(n)``-style Python loops over a
  population/node/destination axis in hot modules: those axes are
  device-vectorized; a Python loop over them is the O(n) dispatch
  pattern the batched paths exist to remove. Reference oracles that
  stay deliberately sequential are inline allowed.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .findings import REPO_ROOT, Finding, is_suppressed, parse_allows

LINT_ROOTS = ("src/repro_torch",)

# Modules whose population/destination axes must stay device-vectorized.
HOT_AXIS_MODULES = (
    "src/repro_torch/kernels/",
    "src/repro_torch/routing/device.py",
    "src/repro_torch/routing/hierarchical.py",
    "src/repro_torch/dse/genomes.py",
    "src/repro_torch/dse/batch.py",
    "src/repro_torch/core/latency.py",
    "src/repro_torch/core/throughput.py",
    "src/repro_torch/opt/space.py",
    "src/repro_torch/opt/algorithms.py",
    "src/repro_torch/serve/",
)

# Modules feeding the device programs: host RNG here breaks the
# reproducibility of their results (seeded streams belong to
# spaces/tests/benchmarks).
DEVICE_PATH_MODULES = (
    "src/repro_torch/kernels/",
    "src/repro_torch/routing/device.py",
    "src/repro_torch/routing/hierarchical.py",
    "src/repro_torch/dse/genomes.py",
    "src/repro_torch/core/latency.py",
    "src/repro_torch/core/throughput.py",
)

# Loop variables of this name over a bare `range(x)` flag `axis-loop`.
AXIS_NAMES = {"n", "p", "pn", "pop", "pop_size", "population",
              "n_chiplets", "n_dest", "n_nodes", "n_designs", "n_src"}

RULES = {
    "no-print": "print() outside obs/log.py (use repro_torch.obs.log)",
    "no-wallclock": "time.time() (use perf_counter/monotonic or obs.trace)",
    "no-np-random": "numpy.random on the device path",
    "env-read": "raw REPRO_* environ read, or a read of an unregistered "
                "knob (use repro_torch.utils.env)",
    "axis-loop": "Python loop over a population/destination axis in a "
                 "hot module",
    "suppression-reason": "repro-lint allow comment without a reason",
}


def _dotted(node: ast.expr) -> str:
    """Best-effort dotted name of an attribute chain ('np.random.rand')."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_env_read(node: ast.AST) -> str | None:
    """REPRO_* key read through os.environ[...] / os.environ.get / or
    os.getenv — returns the key, else None."""
    key_node = None
    if isinstance(node, ast.Subscript):
        if _dotted(node.value) in ("os.environ", "environ"):
            key_node = node.slice
    elif isinstance(node, ast.Call):
        fn = _dotted(node.func)
        if fn in ("os.environ.get", "environ.get", "os.getenv", "getenv",
                  "os.environ.setdefault", "environ.setdefault"):
            key_node = node.args[0] if node.args else None
    if (isinstance(key_node, ast.Constant)
            and isinstance(key_node.value, str)
            and key_node.value.startswith("REPRO_")):
        return key_node.value
    return None


_REGISTRY_READS = ("get_int", "get_opt_int", "get_str", "get_bool")


def _unregistered_knob(node: ast.Call) -> str | None:
    """A registry read (``env.get_int("REPRO_X")``, bare ``get_int(...)``
    too) of a REPRO_* key ``utils.env`` does not register."""
    from ..utils.env import KNOBS

    name = _dotted(node.func).rsplit(".", 1)[-1]
    if name not in _REGISTRY_READS or not node.args:
        return None
    key = node.args[0]
    if (isinstance(key, ast.Constant) and isinstance(key.value, str)
            and key.value.startswith("REPRO_") and key.value not in KNOBS):
        return key.value
    return None


def _axis_loop_name(it: ast.expr) -> str | None:
    """`for _ in range(x)` where x is a name/attribute spelled like a
    population/node axis. Stepped/offset ranges (chunk loops) and small
    static bounds (radix tables etc.) never match."""
    if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
            and it.func.id == "range" and len(it.args) == 1 and not it.keywords):
        return None
    arg = it.args[0]
    name = _dotted(arg) if isinstance(arg, (ast.Name, ast.Attribute)) else ""
    base = name.rsplit(".", 1)[-1].lower()
    return name if base in AXIS_NAMES else None


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.findings: list[Finding] = []
        self.in_src = rel.startswith("src/repro_torch/")
        self.hot_axis = any(rel.startswith(m) for m in HOT_AXIS_MODULES)
        self.device_path = any(rel.startswith(m)
                               for m in DEVICE_PATH_MODULES)

    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(rule=rule, path=self.rel,
                                     line=node.lineno, message=message))

    def visit_Call(self, node: ast.Call) -> None:
        if (self.in_src and self.rel != "src/repro_torch/obs/log.py"
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            self._add("no-print", node,
                      "print() call; route output through repro_torch.obs.log")
        if self.in_src and _dotted(node.func) == "time.time":
            self._add("no-wallclock", node,
                      "time.time(); use time.perf_counter/monotonic or an "
                      "obs.trace span")
        key = _is_env_read(node)
        if key:
            self._add("env-read", node,
                      f"raw read of {key}; use repro_torch.utils.env "
                      "accessors")
        key = _unregistered_knob(node)
        if key:
            self._add("env-read", node,
                      f"{key} is not registered in repro_torch.utils.env")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        key = _is_env_read(node)
        if key:
            self._add("env-read", node,
                      f"raw read of {key}; use repro_torch.utils.env "
                      "accessors")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.device_path:
            dotted = _dotted(node)
            if dotted.startswith(("np.random.", "numpy.random.")) or \
                    dotted in ("np.random", "numpy.random"):
                self._add("no-np-random", node,
                          f"{dotted} on the device path; thread a seeded "
                          "Generator in from the caller")
                return   # don't re-flag the inner np.random node
        self.generic_visit(node)

    def _check_axis_iter(self, node: ast.AST, it: ast.expr) -> None:
        if self.hot_axis:
            name = _axis_loop_name(it)
            if name:
                self._add("axis-loop", node,
                          f"Python for-loop over axis {name!r} in a hot "
                          "module; vectorize or inline-allow with a reason")

    def visit_For(self, node: ast.For) -> None:
        self._check_axis_iter(node, node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_axis_iter(node, gen.iter)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp


def lint_file(path: Path, root: Path = REPO_ROOT) -> list[Finding]:
    rel = path.relative_to(root).as_posix()
    src = path.read_text()
    allows, findings = parse_allows(src.splitlines(), rel)
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return findings + [Finding(rule="syntax-error", path=rel,
                                   line=e.lineno or 0, message=str(e.msg))]
    visitor = _Visitor(rel)
    visitor.visit(tree)
    findings += [f for f in visitor.findings
                 if not is_suppressed(f, allows)]
    return findings


def lint_paths(root: Path = REPO_ROOT,
               roots: tuple[str, ...] = LINT_ROOTS) -> list[Finding]:
    findings: list[Finding] = []
    for sub in roots:
        base = root / sub
        if not base.exists():
            continue
        for path in sorted(base.rglob("*.py")):
            findings += lint_file(path, root)
    return findings
