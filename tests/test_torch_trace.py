"""The port's trace import (``repro_torch.traffic.trace``) and its scalar f64
oracle (``repro_torch.core.reference``) against the JAX package's.

Tolerances: none for the copies. Traces are integer tuples and the
aggregate and the oracle are the same float64 numpy/Python arithmetic in the
same order, so each equals the reference's exactly. The port's f32 proxies
(``evaluate_design(device="cpu")``) are held to the port's oracle within
rtol 1e-5, the reference's own bound between its f32 proxies and its oracle.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (first: repro's modules need repro.core)
from repro.core import reference as ref_reference  # noqa: E402
from repro.traffic import trace as ref_trace  # noqa: E402

import repro_torch.core  # noqa: E402,F401
from repro_torch.core import evaluate_design, reference  # noqa: E402
from repro_torch.core.graph import build_graph  # noqa: E402
from repro_torch.routing.tables import build_routing_table  # noqa: E402
from repro_torch.topologies import TOPOLOGIES, make_design  # noqa: E402
from repro_torch.traffic import (aggregate_trace, make_traffic,  # noqa: E402
                                 parse_trace_file, trace, write_trace_file)

PATTERNS = ("random_uniform", "transpose", "permutation", "hotspot")


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n,n_events,seed", [(16, 200, 0), (64, 1000, 3)])
def test_synthetic_trace_round_trip_equals_reference(tmp_path, pattern, n,
                                                     n_events, seed):
    events = trace.synthetic_trace(n, n_events, seed=seed, pattern=pattern)
    assert events == ref_trace.synthetic_trace(n, n_events, seed=seed,
                                               pattern=pattern)
    path = str(tmp_path / "t.trace")
    write_trace_file(path, events)
    with open(path) as f:
        text = f.read()
    ref_path = str(tmp_path / "ref.trace")
    ref_trace.write_trace_file(ref_path, events)
    with open(ref_path) as f:
        assert f.read() == text
    parsed = parse_trace_file(path)
    assert parsed == ref_trace.parse_trace_file(path)
    assert parsed == sorted(events, key=lambda e: e[0])
    agg = aggregate_trace(parsed, n)
    want = ref_trace.aggregate_trace(parsed, n)
    assert agg.dtype == np.float64 and np.array_equal(agg, want)
    assert abs(agg.sum() - 1.0) < 1e-12 and np.all(np.diag(agg) == 0)


def test_parse_skips_comments_and_sorts(tmp_path):
    path = str(tmp_path / "t.trace")
    with open(path, "w") as f:
        f.write("# cycle src dst size\n\n9 1 2 64\n  # mid comment\n3 2 1 8\n")
    assert parse_trace_file(path) == [(3, 2, 1, 8), (9, 1, 2, 64)]


def test_aggregate_rejects_self_traffic_only():
    with pytest.raises(ValueError, match="no inter-chiplet traffic"):
        aggregate_trace([(0, 1, 1, 64)], 4)


def _graph_and_table(topology: str, n: int):
    design = make_design(topology, n)
    g = build_graph(design)
    return design, g, build_routing_table(g, design.routing,
                                          design.routing_metric, design.seed)


_ORACLE_TOPOLOGIES = [t for t in TOPOLOGIES if t not in ("custom",)]


@pytest.mark.parametrize("topology", _ORACLE_TOPOLOGIES)
def test_oracle_equals_reference_in_f64(topology):
    n = 16
    design, g, nh = _graph_and_table(topology, n)
    t = make_traffic("random_uniform", n)
    traffic = np.zeros((g.n, g.n))
    traffic[:n, :n] = t
    assert reference.latency_reference(g, nh, traffic) == \
        ref_reference.latency_reference(g, nh, traffic)
    assert reference.edge_flows_reference(g, nh, traffic) == \
        ref_reference.edge_flows_reference(g, nh, traffic)
    assert reference.throughput_reference(g, nh, traffic) == \
        ref_reference.throughput_reference(g, nh, traffic)


@pytest.mark.parametrize("topology", ["mesh", "torus", "kite", "hexamesh"])
def test_trace_traffic_proxies_match_the_oracle(topology):
    """A synthetic trace folded into traffic, through the port's f32
    proxies on the CPU, within rtol 1e-5 of the f64 oracle."""
    n = 16
    design, g, nh = _graph_and_table(topology, n)
    traffic = aggregate_trace(trace.synthetic_trace(n, 2000, seed=1), n)
    got = evaluate_design(design, traffic, device="cpu")
    full = np.zeros((g.n, g.n))
    full[:n, :n] = traffic
    np.testing.assert_allclose(
        got.latency, reference.latency_reference(g, nh, full), rtol=1e-5)
    np.testing.assert_allclose(
        got.throughput, reference.throughput_reference(g, nh, full),
        rtol=1e-5)
