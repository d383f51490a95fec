"""The command's contract: what it imports, when it refuses to run, the
last line it prints, and the trace and roofline arithmetic."""
import ast
import io
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
from conftest import ROOT, TINY

from perfbench import devtrace, harness, roofline

BENCH = ROOT / "perfbench"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert files
    for p in files:
        assert not _top_level_imports(p) & {"jax", "jaxlib", "flax", "repro"}, p


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        names = _top_level_imports(p)
        assert "repro_torch" not in names and "perfbench" not in names, p


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.dse", "reproducible", "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jaxlib.xla_client", "flax"]) == ["flax", "jaxlib",
                                                         "repro"]


def _run_py(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "adj256-faults",
         "--seed", "5", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_refuses_without_the_port_beside_it(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_without_a_card():
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(tiny_root, trace):
    result = harness.run(tiny_root, TINY, 9, 1.0, trace, time.perf_counter(),
                         device="cpu")
    keys = list(result)
    assert keys[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(result["device"])
    want = {m["name"] for m in harness.cell_metrics(
        harness.load_manifest(tiny_root), TINY, trace)}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
    else:   # no device on the CPU: the device trace's metrics stay out
        assert {"repair_ms.faults", "dispatch_ms.faults",
                "finish_ms.faults", "host_syncs_per_call.faults"} <= \
            set(result["metrics"])
    out, err = io.StringIO(), io.StringIO()
    harness.report(result, out, err)
    assert json.loads(out.getvalue().splitlines()[-1]) == json.loads(
        json.dumps(result))
    checks = err.getvalue().splitlines()
    assert len(checks) == len(result["checks"])
    assert all(line.startswith("check ") and " limit " in line
               for line in checks)


def _ev(name, t0, t1, device=False, annotation=False):
    kind = "DeviceType.CUDA" if device else "DeviceType.CPU"
    return SimpleNamespace(name=name, device_type=kind,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=t0, end=t1))


def test_trace_reduction():
    events = [_ev("bench.window", 0.0, 1000.0),
              _ev("bench.repair", 0.0, 400.0, annotation=True),
              _ev("bench.dispatch", 400.0, 1000.0, annotation=True),
              _ev("aten::matmul", 450.0, 460.0),
              _ev("bench.dispatch", 400.0, 1000.0, device=True,
                  annotation=True),
              _ev("k1", 300.0, 500.0, device=True),
              _ev("k2", 450.0, 600.0, device=True),
              _ev("k1", 900.0, 1100.0, device=True)]
    readings, breakdown = devtrace.reduce(events, calls=2, rows=8, n=16)
    assert readings["window_s"] == pytest.approx(1e-3)
    assert readings["busy_s"] == pytest.approx(400e-6)   # 300-600, 900-1000
    assert readings["kernel_s"] == pytest.approx({"k1": 400e-6,
                                                  "k2": 150e-6})
    gaps = dict((k, v) for k, v in breakdown["idle_gaps"])
    assert gaps == pytest.approx({"bench.repair/python": 300e-6,
                                  "bench.dispatch/python": 300e-6})
    assert breakdown["device_ops"][0] == ["k1", pytest.approx(400e-6)]


def test_roofline_counts():
    lp = roofline.load_propagation(4, 64)
    assert lp["bytes"] == 16 * 4 * 64 * 64 and lp["by"] == "bytes"
    mp = roofline.minplus_selection(2, 256, 8)
    assert mp["instructions"] == 2 * 2 * 256 * 256 * 8
    assert mp["bytes"] == 12 * 2 * 256 * 256 and mp["by"] == "bytes"
    assert mp["seconds"] == pytest.approx(mp["bytes"] / 3.35e12)


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "adj64-faults",
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_device_readers():
    dev = {"kernel_s": {"void minplus_tiled<32>(...)": 0.5,
                        "load_prop_hops<8>": 0.2, "load_prop_flow": 0.1,
                        "other": 1.0},
           "busy_s": 1.8, "window_s": 4.0, "calls": 3, "rows": 1024,
           "n": 64, "max_degree": 8}
    r = harness.Readings(setup_s=1.0, window_s=2.0, calls=3, call_s=[1.0],
                         evaluations=3, device=dev)
    read = {name: harness.reader(ROOT, name).read(r) for name in (
        "minplus_roofline_pct.faults", "load_prop_roofline_pct.faults",
        "idle_pct.faults")}
    assert read["minplus_roofline_pct.faults"] == pytest.approx(
        100 * 3 * roofline.minplus_selection(1024, 64, 8)["seconds"] / 0.5)
    assert read["load_prop_roofline_pct.faults"] == pytest.approx(
        100 * 3 * roofline.load_propagation(1024, 64)["seconds"] / 0.3)
    assert read["idle_pct.faults"] == pytest.approx(55.0)
    r.device = {**dev, "kernel_s": {"other": 1.0}}
    assert harness.reader(ROOT, "minplus_roofline_pct.faults").read(r) is None
    r.device = None
    assert harness.reader(ROOT, "idle_pct.faults").read(r) is None
