"""The manifest against the benchmark's contract, and every name in it found
as a file."""
import json
import re
import time

from conftest import ROOT, TINY

from perfbench import compare, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def manifest():
    return harness.load_manifest(ROOT)


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "perfbench/run.py"]
    assert m["paths"] == ["perfbench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    m = manifest()
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["end_to_end"] + m["per_layer"]:
        extra = {"workloads"}
        base = ({"name", "unit", "better", "bound", "source"}
                if x in m["end_to_end"] else
                {"name", "unit", "better", "source", "layer", "moves"})
        assert base <= set(x) <= base | extra
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES
        names.append(x["name"])
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert x["moves"] in e2e and one_line(x["layer"])
    assert "setup_s" in e2e
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_and_metric_is_found_by_name():
    m = manifest()
    for w in m["workloads"]:
        spec = harness.find_cell(m, ROOT, w["name"])
        assert spec["config"]["name"] == w["config"]
        assert set(spec["limits"]) == set(compare.NAMES)
        harness.driver(ROOT, spec["mix"]["kind"])
    for x in m["end_to_end"]:
        r = harness.reader(ROOT, x["name"])
        assert (r.SOURCE, r.UNIT) == (x["source"], x["unit"])
    for x in m["per_layer"]:
        r = harness.reader(ROOT, x["name"])
        assert (r.LAYER, r.SOURCE, r.UNIT, r.MOVES) == (
            x["layer"], x["source"], x["unit"], x["moves"])


def test_a_cell_and_a_metric_added_as_files_are_picked_up(tiny_root):
    """A throwaway cell and end-to-end metric: files and manifest entries
    only, no edit of any file the benchmark has."""
    (tiny_root / "perfbench" / "metrics" / "calls_done.py").write_text(
        'SOURCE = "host_clock"\nUNIT = "calls"\n\n\n'
        "def read(r):\n    return r.calls\n")
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["end_to_end"].append({"name": "calls_done", "unit": "calls",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": [TINY]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    result = harness.run(tiny_root, TINY, 5, 1.0, False, time.perf_counter(),
                         device="cpu")
    assert result["correct"]
    assert result["metrics"]["calls_done"]["value"] >= 1
    assert {"evals_per_s", "call_p95_ms", "setup_s"} <= set(result["metrics"])
