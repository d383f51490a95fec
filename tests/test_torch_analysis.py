"""The port's static-analysis gate (``repro_torch.analysis``) on the CPU.

Every lint rule fires on a planted fixture and its inline allow suppresses
it; the port's tree lints clean against its own (empty) baseline. Every
audit check catches a planted program — the float64 fixture included,
which the reference's gate can no longer catch under jax 0.9 — and every
registry contract passes with ``device="cpu"``. No tolerances: findings
are counted exactly.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (first: repro's modules need repro.core)
import repro_torch.core  # noqa: E402,F401
from repro_torch.analysis import findings as fmod  # noqa: E402
from repro_torch.analysis import graph_audit as ga  # noqa: E402
from repro_torch.analysis.__main__ import main  # noqa: E402
from repro_torch.analysis.lint import RULES, lint_file, lint_paths  # noqa: E402
from repro_torch.analysis.registry import contracts, large_n_plan  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# rule -> (module path relative to the root, a line that breaks the rule)
_LINT_FIXTURES = {
    "no-print": ("src/repro_torch/core/x.py", 'print("hi")'),
    "no-wallclock": ("src/repro_torch/core/x.py", "t = time.time()"),
    "no-np-random": ("src/repro_torch/kernels/x.py",
                     "r = np.random.default_rng(0)"),
    "env-read": ("src/repro_torch/core/x.py",
                 'v = os.environ.get("REPRO_APSP_TILE")'),
    "axis-loop": ("src/repro_torch/dse/genomes.py",
                  "for i in range(n_chiplets): pass"),
}


def _lint(tmp_path, rel: str, body: str):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("import os, time\nimport numpy as np\n" + body + "\n")
    return lint_file(path, tmp_path)


def _ref_lint(tmp_path, rel: str, body: str):
    """The reference's lint of the same fixture, written at the same module
    of the reference's tree (``src/repro_torch/`` -> ``src/repro/``)."""
    rel = rel.replace("src/repro_torch/", "src/repro/", 1)
    path = tmp_path / "ref" / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("import os, time\nimport numpy as np\n" + body + "\n")
    return ref_lint.lint_file(path, tmp_path / "ref")


def _lint_both(tmp_path, rel: str, body: str) -> list:
    """The port's (rule, line) findings of a fixture, asserted equal to the
    reference's on the same fixture."""
    port = [(f.rule, f.line) for f in _lint(tmp_path, rel, body)]
    assert port == [(f.rule, f.line) for f in _ref_lint(tmp_path, rel, body)]
    return port


@pytest.mark.parametrize("rule", sorted(_LINT_FIXTURES))
def test_lint_rule_fires_and_inline_allow_suppresses(tmp_path, rule):
    """Each rule fires on its fixture, and both inline allows suppress it,
    exactly as the reference's lint does on the same fixture."""
    rel, line = _LINT_FIXTURES[rule]
    found = _lint(tmp_path, rel, line)
    assert [(f.rule, f.line, f.path) for f in found] == [(rule, 3, rel)]
    assert _lint_both(tmp_path, rel, line) == [(rule, 3)]
    allowed = f"# repro-lint: allow[{rule}] planted fixture\n{line}"
    assert _lint_both(tmp_path, rel, allowed) == []
    same_line = f"{line}  # repro-lint: allow[{rule}] planted fixture"
    assert _lint_both(tmp_path, rel, same_line) == []
    assert set(_LINT_FIXTURES) | {"suppression-reason"} == set(RULES)
    assert set(RULES) == set(ref_lint.RULES)


def test_lint_scope_of_each_rule(tmp_path):
    # print is fine in obs/log.py; np.random and loops outside their modules
    assert _lint_both(tmp_path, "src/repro_torch/obs/log.py",
                      'print("x")') == []
    assert _lint_both(tmp_path, "src/repro_torch/opt/operators.py",
                      "r = np.random.default_rng(0)") == []
    assert _lint_both(tmp_path, "src/repro_torch/core/reports.py",
                      "for i in range(n): pass") == []
    # a stepped range is a chunk loop, not an axis loop
    assert _lint_both(tmp_path, "src/repro_torch/kernels/x.py",
                      "for i in range(0, n, 8): pass") == []


# module of the port -> fixture lines; every module the port's lint scopes
# a rule to, each linted by both packages at its counterpart
_SCOPED_MODULES = sorted({m for m in ("src/repro_torch/kernels/ops.py",
                                      "src/repro_torch/routing/device.py",
                                      "src/repro_torch/routing/hierarchical.py",
                                      "src/repro_torch/dse/genomes.py",
                                      "src/repro_torch/dse/batch.py",
                                      "src/repro_torch/core/latency.py",
                                      "src/repro_torch/core/throughput.py",
                                      "src/repro_torch/opt/space.py",
                                      "src/repro_torch/opt/algorithms.py",
                                      "src/repro_torch/serve/job.py",
                                      "src/repro_torch/obs/log.py",
                                      "src/repro_torch/core/reports.py")})
_SCOPED_BODY = "\n".join([
    'print("x")',
    "t = time.time()",
    "r = np.random.default_rng(0)",
    'v = os.getenv("REPRO_LOG")',
    "for i in range(pop_size): pass",
    "for d in range(n_dest): pass",
    "for i in range(0, n, 8): pass",
    "while True: break",
    "# repro-lint: allow[no-wallclock]",
    "t = time.time()",
])


@pytest.mark.parametrize("rel", _SCOPED_MODULES)
def test_lint_scopes_equal_the_references(tmp_path, rel):
    """Every rule at every module it is scoped to (and at two it is not),
    linted by both packages at the same module: the same (rule, line)
    findings and the same suppressions."""
    found = _lint_both(tmp_path, rel, _SCOPED_BODY)
    assert ("no-wallclock", 4) in found
    assert ("suppression-reason", 11) in found


def test_env_read_checks_the_registry(tmp_path):
    rel = "src/repro_torch/core/x.py"
    ok = _lint(tmp_path, rel, 'v = _env.get_int("REPRO_APSP_FUSED_N")')
    assert ok == []
    bad = _lint(tmp_path, rel, 'v = _env.get_int("REPRO_NOT_A_KNOB")')
    assert [f.rule for f in bad] == ["env-read"]
    assert "not registered" in bad[0].message
    raw = _lint(tmp_path, rel, 'v = os.environ["REPRO_LOG"]')
    assert [f.rule for f in raw] == ["env-read"]


def test_allow_without_reason_is_a_finding(tmp_path):
    found = _lint(tmp_path, "src/repro_torch/core/x.py",
                  '# repro-lint: allow[no-print]\nprint("x")')
    assert [f.rule for f in found] == ["suppression-reason"]


def test_port_tree_lints_clean_against_its_baseline():
    baseline = fmod.load_baseline()
    assert fmod.BASELINE_PATH.name == "baseline.json"
    assert fmod.BASELINE_PATH.parent.name == "analysis"
    assert baseline == set()
    assert fmod.apply_baseline(lint_paths(), baseline) == []
    # only the port is linted
    assert all(f.path.startswith("src/repro_torch/") for f in lint_paths(
        roots=("src/repro_torch",)))


def test_baseline_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "baseline.json"
    monkeypatch.setattr(fmod, "BASELINE_PATH", path)
    a = fmod.Finding("no-print", "src/repro_torch/x.py", 3, "m")
    b = fmod.Finding("audit-f64", ga.REGISTRY_PATH, 0, "m", contract="c")
    assert fmod.write_baseline([a, b, a]) == 2
    assert fmod.load_baseline() == {a.key(), b.key()}
    moved = fmod.Finding("no-print", "src/repro_torch/x.py", 9, "m")
    assert fmod.apply_baseline([moved], fmod.load_baseline()) == []


# ---------------------------------------------------------------------------
# level 1: the recorded-program audit
# ---------------------------------------------------------------------------

def _contract(fn, *args, **kw) -> ga.Contract:
    return ga.Contract(name="fixture", trace=lambda dev: ga.record(fn, *args),
                       **kw)


def _rules(c, device="cpu") -> list[str]:
    return [f.rule for f in ga.audit_contract(c, device)]


def _scatter(x, idx):
    y = x.clone()
    y[idx] = 1.0
    return y


_X = torch.arange(12.0).reshape(3, 4)
_IDX = torch.tensor([0, 2])

# check -> (program, args, contract fields, expected rule)
_AUDIT_FIXTURES = {
    "index_put": (_scatter, (_X, _IDX), dict(forbidden_ops=ga.SCATTER_OPS),
                  "audit-forbidden-op"),
    "index_add": (lambda x, i: x.index_add(0, i, x[:2]), (_X, _IDX),
                  dict(forbidden_ops=ga.SCATTER_OPS), "audit-forbidden-op"),
    "scatter_add": (lambda x, i: x.scatter_add(0, i[None].repeat(3, 1)
                                               .narrow(1, 0, 2), x[:, :2]),
                    (_X, _IDX), dict(forbidden_ops=ga.SCATTER_OPS),
                    "audit-forbidden-op"),
    "f64": (lambda x: x.to(torch.float64).sum().to(torch.float32), (_X,),
            dict(forbid_f64=True), "audit-f64"),
    "transient": (lambda x: (x[:, :, None] * x[:, None, :]).sum(-1), (_X,),
                  dict(max_transient_elements=40), "audit-transient-bound"),
    "shape": (lambda x: x[:, None, :].expand(3, 5, 4).contiguous().sum(1),
              (_X,), dict(dims={"a": 3, "b": 5, "c": 4},
                          forbidden_shapes=(("a", "b", "c"),)),
              "audit-forbidden-shape"),
    "gather_index": (lambda x, i: x.index_select(0, i.to(torch.int32)),
                     (_X, _IDX), dict(gather_index_min_bits=64),
                     "audit-gather-index"),
    "out_dtype": (lambda x: x.to(torch.int16), (_X,),
                  dict(out_dtypes=(torch.float32,)), "audit-out-dtype"),
}


@pytest.mark.parametrize("check", sorted(_AUDIT_FIXTURES))
def test_audit_check_catches_planted_fixture(check):
    fn, args, fields, rule = _AUDIT_FIXTURES[check]
    # one finding per offending op name (the f64 fixture has two)
    assert set(_rules(_contract(fn, *args, **fields))) == {rule}
    # the same contract without the check is clean
    assert _rules(_contract(fn, *args)) == []


@pytest.mark.parametrize("check", ["index_put", "f64", "gather_index"])
def test_audit_passes_the_clean_twin(check):
    clean = {
        "index_put": lambda x, i: torch.where(
            (torch.arange(3)[:, None] == i).any(1)[:, None], 1.0, x),
        "f64": lambda x: x.sum(),
        "gather_index": lambda x, i: x.index_select(0, i),
    }[check]
    fn, args, fields, _ = _AUDIT_FIXTURES[check]
    assert _rules(_contract(clean, *args, **fields)) == []
    assert torch.equal(ga.record(clean, *args).outputs,
                       ga.record(fn, *args).outputs)


def test_audit_ladder_counts_distinct_programs():
    def run(n):
        return ga.record(lambda x: x * 2, torch.ones(n))

    c = ga.Contract(name="ladder", trace=lambda dev: ga.record(torch.neg, _X),
                    ladder=lambda dev: [run(n) for n in (8, 8, 16, 32)],
                    ladder_expected=3)
    assert _rules(c) == []
    info: dict = {}
    ga.audit_contract(c, "cpu", info)
    assert [tuple(t.outputs.shape) for t in info["runs"]] == \
        [(3, 4), (8,), (8,), (16,), (32,)]
    c.ladder_expected = 2
    assert _rules(c) == ["audit-recompile"]


def _per_device(cpu_fn, card_fn, n=5):
    """A contract whose program is ``cpu_fn`` when recorded for the CPU and
    ``card_fn`` otherwise, with a two-size ladder; its inputs stay on the
    host, so the card's path of the audit runs here."""
    def run(dev, k):
        fn = cpu_fn if dev.type == "cpu" else card_fn
        return ga.record(fn, torch.linspace(-1.0, 1.0, k))

    return ga.Contract(name="parity", trace=lambda dev: run(dev, n),
                       ladder=lambda dev: [run(dev, 3), run(dev, 4)],
                       ladder_expected=2, parity=(0.0, 0.0))


@pytest.mark.parametrize("case", ["bits", "tolerance", "ladder", "dtype"])
def test_audit_holds_card_runs_against_the_cpu(monkeypatch, case):
    """On a CUDA device a contract with ``parity`` records every run again
    on the CPU: outputs out of tolerance, in the contract's own run or in a
    ladder's, are a finding; outputs within it are not."""
    monkeypatch.setattr(ga, "launch_counts", dict)
    card = {"bits": lambda x: x * 3.0 + 1e-7,
            "tolerance": lambda x: x * 3.0 + 1e-7,
            "ladder": lambda x: x * (3.0 if x.numel() == 5 else 2.0),
            "dtype": lambda x: (x * 3.0).to(torch.float64)}[case]
    c = _per_device(lambda x: x * 3.0, card)
    if case == "tolerance":
        c.parity = (0.0, 1e-6)
    info: dict = {}
    found = ga.audit_contract(c, "cuda", info)
    assert len(info["runs"]) == 3
    if case == "tolerance":
        assert found == [] and 0.0 < info["cpu_max_abs_err"] <= 1e-6
    else:
        assert [f.rule for f in found] == ["audit-cpu-parity"]
        assert info["cpu_max_abs_err"] > 0.0
    # the CPU's audit has nothing to compare with
    assert ga.audit_contract(c, "cpu") == []


def test_output_error_compares_values_shapes_and_dtypes():
    inf = float("inf")
    a = (torch.tensor([1.0, inf, 2.0]), torch.tensor([3, 4], dtype=torch.int16))
    assert ga.output_error(a, tuple(t.clone() for t in a), 0.0, 0.0) == \
        (0.0, True)
    b = (torch.tensor([1.0, inf, 2.5]), a[1])
    assert ga.output_error(b, a, 0.0, 0.0) == (0.5, False)
    assert ga.output_error(b, a, 0.3, 0.0) == (0.5, True)
    c = (a[0], torch.tensor([3, 5], dtype=torch.int16))
    assert ga.output_error(c, a, 1.0, 1.0) == (1.0, False)
    assert ga.output_error((a[0],), a, 0.0, 0.0)[1] is False
    assert ga.output_error((a[0], a[1].to(torch.int32)), a, 0.0, 0.0)[1] \
        is False


def test_program_key_ignores_loop_trip_counts():
    def loop(x, k):
        for _ in range(k):
            x = x * 0.5 + 1.0
        return x

    keys = {ga.program_key(ga.record(loop, torch.ones(4), k))
            for k in (1, 3, 7)}
    assert len(keys) == 1
    assert ga.program_key(ga.record(loop, torch.ones(5), 3)) not in keys


def test_audit_reports_a_program_that_fails():
    def broken(dev):
        raise RuntimeError("planted")

    assert _rules(ga.Contract(name="x", trace=broken)) == ["audit-trace-error"]


def test_audit_kernel_route_on_cuda(monkeypatch):
    """On a CUDA device the contract's kernels must launch: a counter that
    does not move is a finding, one that moves is not. (The program runs
    on the host here; only the counters are read on the card's path.)"""
    counts = {"minplus_cuda": 0}
    monkeypatch.setattr(ga, "launch_counts", lambda: dict(counts))
    idle = ga.Contract(name="k", trace=lambda dev: ga.record(torch.neg, _X),
                       kernels=("minplus_cuda",))
    assert _rules(idle, "cuda") == ["audit-kernel-route"]
    assert _rules(idle, "cpu") == []

    def launching(dev):
        counts["minplus_cuda"] += 1
        return ga.record(torch.neg, _X)

    busy = ga.Contract(name="k", trace=launching, kernels=("minplus_cuda",))
    assert _rules(busy, "cuda") == []


def _host_stack(bits, deg):
    """A host program that builds a [P, n, n] stack."""
    stack = deg[:, :, None] * deg[:, None, :]
    return stack.sum()


def test_record_numpy_catches_a_host_transient():
    deg = np.ones((12, 16), np.int64)
    trace = ga.record_numpy(_host_stack, None, deg, function="_host_stack",
                            module="test_torch_analysis.py")
    shapes = {o.outputs[0][0] for o in trace.ops}
    assert (12, 16, 16) in shapes
    c = ga.Contract(name="host", trace=lambda dev: trace,
                    dims={"P": 12, "n": 16},
                    forbidden_shapes=(("P", "n", "n"),))
    assert _rules(c) == ["audit-forbidden-shape"]


@pytest.mark.parametrize("name", [c.name for c in contracts()])
def test_registry_contract_passes_on_cpu(name):
    c = next(c for c in contracts() if c.name == name)
    assert ga.audit_contract(c, "cpu") == []


def test_every_kernel_contract_is_held_against_the_cpu():
    """Every contract whose program launches a kernel on the card records
    its runs again on the CPU there: bits for the min-plus programs, f32
    rounding for the float sums."""
    for c in contracts():
        if c.kernels:
            assert c.parity is not None, c.name
        if c.name.startswith(("ops.apsp", "routing.")):
            assert c.parity == (0.0, 0.0), c.name
        elif c.parity is not None:
            assert c.parity == (1e-5, 1e-6), c.name


def test_registry_names_and_plan_follow_the_reference():
    names = {c.name for c in contracts()}
    assert {"dse.genomes.adjacency[n=16]",
            "dse.genomes.adjacency_faults[n=16,P=8,F=4]",
            "dse.genomes.parametric[n<=48]",
            "opt.space.repair_cap[n=16,P=12]",
            "routing.lowest_id_next_hops[dense,n=64,B=2]",
            "routing.lowest_id_next_hops[blocked,n=256,B=1]",
            "routing.hops_next_hop[dense,n=64,B=2]",
            "routing.hops_next_hop[blocked,n=256,B=1]"} <= names
    assert large_n_plan() == {
        "load_propagate": {"dense_max_n": 256, "dense": "dense",
                           "blocked": "slab"},
        "apsp": {"dense_max_n": 256, "dense": "fused", "blocked": "tiled"}}


def test_repair_cap_contract_runs_the_repairs_scan():
    """The audited host scan is the one ``repair`` runs: repair's output
    equals the reference's, and the recorded arrays include the scan's
    [P, G] bits."""
    from repro.opt.space import AdjacencySpace as RefSpace
    from repro_torch.opt.space import AdjacencySpace

    rng = np.random.default_rng(3)
    bits = (rng.random((12, 120)) < 0.7).astype(np.int64)
    assert np.array_equal(AdjacencySpace(16).repair(bits),
                          RefSpace(16).repair(bits))
    c = next(c for c in contracts() if c.name.startswith("opt.space"))
    shapes = {o.outputs[0][0] for o in c.trace(torch.device("cpu")).ops}
    assert (12, 120) in shapes and (12, 16) in shapes


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_env_lists_the_ports_knobs(capsys):
    from repro_torch.utils.env import KNOBS

    assert main(["--env"]) == 0
    out = capsys.readouterr().out
    for name in KNOBS:
        assert name in out


def test_cli_list_names_rules_and_programs(capsys):
    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out
    for c in contracts():
        assert c.name in out


def test_cli_check_on_cpu_exits_zero_and_writes_json(tmp_path):
    out = str(tmp_path / "f.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.abspath(SRC) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--check", "--device", "cpu", "--json", out],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "analysis: clean (0 findings)" in res.stdout
    with open(out) as f:
        assert json.load(f) == []


def test_cli_exit_status_counts_findings(monkeypatch, capsys):
    planted = [fmod.Finding("no-print", "src/repro_torch/x.py", i, "m")
               for i in range(1, 131)]
    import repro_torch.analysis.__main__ as cli

    monkeypatch.setattr(cli, "_collect", lambda *a, **k: planted[:3])
    assert main(["--lint", "--no-baseline"]) == 3
    monkeypatch.setattr(cli, "_collect", lambda *a, **k: planted)
    assert main(["--lint", "--no-baseline"]) == 125
    assert "130 finding(s)" in capsys.readouterr().out
