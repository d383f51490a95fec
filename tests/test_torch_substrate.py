"""The port's copied host substrate against ``repro``: graphs, step costs,
traffic and routing tables must be exactly equal (integer and float arrays
alike: the copies run the same numpy code)."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core  # noqa: F401  (first: repro.routing needs repro.core loaded)
from repro.core import graph as ref_graph
from repro.routing import tables as ref_tables
from repro.topologies import TOPOLOGIES as REF_TOPOLOGIES
from repro.topologies import make_design as ref_make_design
from repro.traffic import make_traffic as ref_make_traffic

from repro_torch.core import graph
from repro_torch.routing import tables
from repro_torch.topologies import TOPOLOGIES, make_design
from repro_torch.traffic import TRAFFIC_PATTERNS, make_traffic

N = 16
ALGORITHMS = sorted(ref_tables.ROUTING_ALGORITHMS)


def _both_designs(name: str):
    """(reference design, port design) at 16 chiplets; the same exception
    type from both where the reference cannot build the name at 16."""
    try:
        ref = ref_make_design(name, N)
    except (ValueError, TypeError) as exc:
        with pytest.raises(type(exc)):
            make_design(name, N)
        return None, None
    return ref, make_design(name, N)


def test_registries_agree():
    assert sorted(TOPOLOGIES) == sorted(REF_TOPOLOGIES)
    assert sorted(tables.ROUTING_ALGORITHMS) == ALGORITHMS


@pytest.mark.parametrize("name", sorted(REF_TOPOLOGIES))
def test_graph_and_step_costs_equal(name):
    ref, port = _both_designs(name)
    if ref is None:
        return
    g_ref, g = ref_graph.build_graph(ref), graph.build_graph(port)
    assert (g.n, g.n_chiplets) == (g_ref.n, g_ref.n_chiplets)
    for field in ("node_weight", "adj_lat", "adj_bw", "lengths", "relay"):
        np.testing.assert_array_equal(getattr(g, field), getattr(g_ref, field))
    np.testing.assert_array_equal(graph.step_cost_matrix(g),
                                  ref_graph.step_cost_matrix(g_ref))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("name", sorted(REF_TOPOLOGIES))
def test_routing_tables_equal(name, algorithm):
    ref, port = _both_designs(name)
    if ref is None:
        return
    g_ref, g = ref_graph.build_graph(ref), graph.build_graph(port)
    for metric, seed in (("hops", 0), ("latency", 7)):
        want = ref_tables.build_routing_table(g_ref, algorithm, metric, seed)
        got = tables.build_routing_table(g, algorithm, metric, seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pattern", sorted(TRAFFIC_PATTERNS))
def test_traffic_equal(pattern):
    for n, seed in ((16, 0), (36, 3), (64, 11)):
        np.testing.assert_array_equal(make_traffic(pattern, n, seed=seed),
                                      ref_make_traffic(pattern, n, seed=seed))


def test_updown_random_depends_on_the_seed():
    g = graph.build_graph(make_design("mesh", N))
    g_ref = ref_graph.build_graph(ref_make_design("mesh", N))
    a = tables.build_routing_table(g, "updown_random", seed=1)
    b = tables.build_routing_table(g, "updown_random", seed=2)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(
        b, ref_tables.build_routing_table(g_ref, "updown_random", seed=2))
