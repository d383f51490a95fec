"""The port's single-design path (``evaluate_design`` and the latency and
throughput pieces under it) against ``repro.core`` on the CPU.
Tolerance: latency and throughput within rtol 1e-5 (f32 sums in another
order); path costs and hop counts within rtol 1e-6; area, power and cost
exactly equal (the same numpy code on both sides)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
import jax.numpy as jnp
from repro.core import latency as ref_latency
from repro.core import throughput as ref_throughput
from repro.topologies import make_design as ref_make_design
from repro.traffic import make_traffic as ref_make_traffic

from repro_torch.core import (evaluate_design, latency, prepare_arrays,
                              throughput)
from repro_torch.topologies import make_design
from repro_torch.traffic import make_traffic

RTOL = 1e-5
PATTERNS = ("random_uniform", "transpose", "permutation", "hotspot")


def _custom_edges(n: int) -> list:
    """A ring plus chords: a free-form topology for the custom entry."""
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(i, (i + n // 3) % n) for i in range(0, n, 3)]
    return edges


def _designs(topology: str, n: int):
    kw = {"edges": _custom_edges(n)} if topology == "custom" else {}
    return ref_make_design(topology, n, **kw), make_design(topology, n, **kw)


@pytest.mark.parametrize("n", [16, 36, 64])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("topology", ["mesh", "hexamesh", "kite", "custom"])
def test_evaluate_design_matches_reference(topology, pattern, n):
    ref_design, design = _designs(topology, n)
    want = ref_core.evaluate_design(ref_design, ref_make_traffic(pattern, n))
    got = evaluate_design(design, make_traffic(pattern, n), device="cpu")
    np.testing.assert_allclose(got.latency, want.latency, rtol=RTOL)
    np.testing.assert_allclose(got.throughput, want.throughput, rtol=RTOL)
    g, w = got.to_dict(), want.to_dict()
    for key in ("total_chiplet_area", "interposer_area", "power", "cost"):
        assert g[key] == w[key], key
    assert vars(got.area) == vars(want.area)
    assert vars(got.power) == vars(want.power)
    assert vars(got.cost) == vars(want.cost)


def _arrays(topology: str, n: int, routing: str = "dijkstra_lowest_id"):
    design = make_design(topology, n, routing=routing)
    arrays, _ = prepare_arrays(design)
    return arrays


@pytest.mark.parametrize("topology,routing", [
    ("mesh", "dijkstra_lowest_id"), ("kite", "updown_random"),
    ("hexatorus", "updown_random")])
def test_path_costs_and_hops(topology, routing):
    a = _arrays(topology, 36, routing)
    nh, sc, nw = (torch.from_numpy(a.next_hop), torch.from_numpy(a.step_cost),
                  torch.from_numpy(a.node_weight))
    want = np.asarray(ref_latency.path_cost_doubling(
        jnp.asarray(a.next_hop), jnp.asarray(a.step_cost),
        jnp.asarray(a.node_weight)))
    np.testing.assert_allclose(latency.path_cost_doubling(nh, sc, nw).numpy(),
                               want, rtol=1e-6)
    np.testing.assert_array_equal(
        latency.routed_hops(nh).numpy(),
        np.asarray(ref_latency.routed_hops(jnp.asarray(a.next_hop))))
    assert latency.routed_diameter(nh) == ref_latency.routed_diameter(
        a.next_hop)
    k = a.next_hop.shape[0]
    isolated = np.tile(np.arange(k, dtype=np.int32)[:, None], (1, k))
    stacked = np.stack([a.next_hop, isolated])
    np.testing.assert_array_equal(
        latency.routed_diameter_batch(stacked, device="cpu"),
        ref_latency.routed_diameter_batch(stacked))


def test_flow_diagnostics_match_reference():
    a = _arrays("hexamesh", 16)
    t = make_traffic("hotspot", 16).astype(np.float32)
    nh, bw, tt = (torch.from_numpy(a.next_hop), torch.from_numpy(a.adj_bw),
                  torch.from_numpy(t))
    jnh, jbw, jt = jnp.asarray(a.next_hop), jnp.asarray(a.adj_bw), jnp.asarray(t)
    np.testing.assert_allclose(
        throughput.edge_flows_load(nh, tt).numpy(),
        np.asarray(ref_throughput.edge_flows_load(jnh, jt)), rtol=RTOL,
        atol=1e-7)
    np.testing.assert_allclose(
        throughput.throughput_proxy(nh, bw, tt, directed=True).numpy(),
        np.asarray(ref_throughput.throughput_proxy(jnh, jbw, jt,
                                                   directed=True)), rtol=RTOL)
    ratio, arg = throughput.bottleneck_edges(nh, bw, tt)
    r_ratio, r_arg = ref_throughput.bottleneck_edges(jnh, jbw, jt)
    np.testing.assert_allclose(ratio.numpy(), np.asarray(r_ratio), rtol=RTOL)
    assert int(arg) == int(r_arg)


def test_reachable_fraction_matches_reference():
    a = _arrays("mesh", 16)
    t = make_traffic("random_uniform", 16).astype(np.float32)
    cut = a.next_hop.copy()
    cut[:, 5] = np.arange(16)          # nobody reaches chiplet 5
    cut[5, 5] = 5
    both = np.stack([a.next_hop, cut])
    got = throughput.reachable_fraction(torch.from_numpy(both),
                                        torch.from_numpy(t))
    want = ref_throughput.reachable_fraction(jnp.asarray(both), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got[0]) == 1.0 and float(got[1]) < 1.0


def test_router_padded_traffic_and_cropped_latency():
    """Interposer topologies carry routers: traffic covers the chiplets
    only and is padded (throughput) or the path costs cropped (latency)."""
    a = _arrays("double_butterfly", 16)
    assert a.next_hop.shape[0] > a.n_chiplets
    t = make_traffic("random_uniform", 16).astype(np.float32)
    got = latency.average_latency(
        torch.from_numpy(a.next_hop), torch.from_numpy(a.step_cost),
        torch.from_numpy(a.node_weight), torch.from_numpy(t))
    want = ref_latency.average_latency(
        jnp.asarray(a.next_hop), jnp.asarray(a.step_cost),
        jnp.asarray(a.node_weight), jnp.asarray(t))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
