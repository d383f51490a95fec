"""Shared fixtures of the benchmark's CPU tests: the repository on the path
and a copy of the benchmark with a tiny cell added as files."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = "adj16-faults"


def add_tiny_cell(root: Path) -> None:
    """A 16-chiplet cell (8 offspring x 4 scenarios at p = 0.1), added to
    ``root``'s benchmark as files and manifest entries only."""
    bench = root / "perfbench"
    cfg = json.loads((bench / "configs" / "adjacency-64.json").read_text())
    cfg.update(name="adjacency-16", n_chiplets=16, max_degree=4)
    (bench / "configs" / "adjacency-16.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "faults-p512-f512.json")
                     .read_text())
    mix.update(population=8, scenarios=4, parent_pool=8, trace_calls=3,
               link_fail_p=0.1)
    (bench / "traffic" / "faults-p8-f4.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits" / "adj64-faults.json",
                bench / "limits" / f"{TINY}.json")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "adjacency-16", "source": "test",
                         "file": "perfbench/configs/adjacency-16.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": TINY, "config": "adjacency-16",
                           "traffic": "faults-p8-f4", "chips": 1,
                           "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cell(root)
    return root
