"""One run of one benchmark cell, driven by ``BENCHMARK.json`` and files
found by name:

* the cell's configuration: the ``file`` its ``configs`` entry names;
* its traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``kind``
  names the load driver ``perfbench/kinds/<kind>.py``;
* the limits of its correctness comparison: ``perfbench/limits/<cell>.json``;
* each metric's reader: ``perfbench/metrics/<metric>.py``.

The driver sets up, warms up, measures for ``--seconds`` and compares what
the timed path produced with the plain reference; this module turns what it
recorded into the metrics, prints each compared number beside its limit on
standard error and, as the last line of standard output, the result.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Readings:
    """What a run recorded, as the metric readers see it."""
    setup_s: float
    window_s: float
    calls: int
    call_s: list
    evaluations: int
    repair_s: float | None = None      # trace runs: the benchmark's span
    spans: dict | None = None          # trace runs: program span seconds
    counters: dict | None = None       # program counter deltas
    device: dict | None = None         # trace runs: the profiled calls


@dataclass
class Outcome:
    """What a load driver hands back."""
    readings: Readings
    checks: dict                       # name -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    breakdown: dict | None = None
    setup_parts: dict | None = None     # what set-up built, warm-up times


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_manifest(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def load_file_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(manifest: dict, root: Path, workload: str) -> dict:
    """The cell's manifest entries and the data files they name."""
    root = Path(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    cell = cells[workload]
    config_file = next(c["file"] for c in manifest["configs"]
                       if c["name"] == cell["config"])
    bench = root / "perfbench"
    return {"cell": cell,
            "config": json.loads((root / config_file).read_text()),
            "mix": json.loads((bench / "traffic"
                               / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads((bench / "limits"
                                  / f"{workload}.json").read_text())}


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if "workloads" not in m or workload in m["workloads"]]


def reader(root: Path, name: str):
    return load_file_module(Path(root) / "perfbench" / "metrics"
                            / f"{name}.py", f"perfbench_metric_{name}")


def driver(root: Path, kind: str):
    return load_file_module(Path(root) / "perfbench" / "kinds"
                            / f"{kind}.py", f"perfbench_kind_{kind}")


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", program=None) -> dict:
    """Set up, measure and compare one cell; returns the result object
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``breakdown`` where traced, ``setup`` where the driver times set-up's
    parts, ``checks`` last). ``program`` replaces the
    timed path's entry points (``repair``, ``evaluate``): the tests plant
    faults through it."""
    root = Path(root)
    manifest = load_manifest(root)
    spec = find_cell(manifest, root, workload)
    kind = driver(root, spec["mix"]["kind"])
    outcome = kind.run(spec, seed=seed, seconds=seconds, trace=trace,
                       t0=t0, device=device, program=program)
    metrics = {}
    for m in cell_metrics(manifest, workload, trace):
        value = reader(root, m["name"]).read(outcome.readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "count": spec["cell"]["chips"],
           "memory_peak_bytes": outcome.memory_peak_bytes}
    if device == "cuda":
        import torch
        dev["kind"] = torch.cuda.get_device_name(0)
        dev["power"] = power_limit()
    else:
        dev["kind"] = device
    if trace and outcome.readings.device:
        dev["busy_s"] = outcome.readings.device["busy_s"]
        dev["window_s"] = outcome.readings.device["window_s"]
    correct = all(v <= lim for v, lim in outcome.checks.values())
    result = {"correct": correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": dev}
    if outcome.breakdown is not None:
        result["breakdown"] = outcome.breakdown
    if outcome.setup_parts is not None:
        result["setup"] = outcome.setup_parts
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in outcome.checks.items()}
    return result


def report(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, and the result as the last line of standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
