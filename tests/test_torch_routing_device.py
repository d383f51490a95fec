"""The port's device routing tables (``repro_torch.routing.device``) on the
CPU against the JAX package's ``repro.routing.device`` and the host tables,
on the random graphs of ``tests/test_device_path.py``. Tolerance: none.
Tables are integers and must be exactly equal: lowest-ID tables with and
without relay masks, the hops builder dense and destination-blocked, and
the up*/down* tables with the same seeded RNG stream."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (first: repro's modules need repro.core loaded)
import jax.numpy as jnp
from repro.core.graph import DenseGraph as RefGraph
from repro.routing import device as ref_device
from repro.routing import hierarchical as ref_hier
from repro.routing.tables import (dijkstra_lowest_id_table_reference,
                                  updown_random_table_reference)

import repro_torch.core  # noqa: F401  (first, as in repro)
from repro_torch.core.graph import DenseGraph
from repro_torch.routing import device, hierarchical
from repro_torch.routing.tables import _edge_costs, updown_random_table


def _random_graph(n: int, rng, relay_frac: float = 1.0):
    """Random connected graph with optional non-relay vertices, as the
    port's and the reference's DenseGraph."""
    adj = np.full((n, n), np.inf)
    perm = rng.permutation(n)
    for i in range(1, n):
        j = perm[rng.integers(0, i)]
        adj[perm[i], j] = adj[j, perm[i]] = 1.0
    for _ in range(2 * n):
        u, v = rng.integers(0, n, 2)
        if u != v:
            adj[u, v] = adj[v, u] = 1.0
    relay = rng.random(n) < relay_frac
    kw = dict(n=n, n_chiplets=n, node_weight=np.zeros(n), adj_lat=adj,
              adj_bw=np.ones((n, n)), lengths=np.zeros((n, n)), relay=relay)
    return DenseGraph(**kw), RefGraph(**kw)


def _adjacency(g) -> np.ndarray:
    adj = np.isfinite(g.adj_lat)
    np.fill_diagonal(adj, False)
    return adj


@pytest.mark.parametrize("seed,relay_frac", [(0, 1.0), (1, 0.7), (2, 1.0),
                                             (3, 0.75)])
def test_lowest_id_tables_match_reference_and_host(seed, relay_frac):
    rng = np.random.default_rng(seed)
    g, rg = _random_graph(int(rng.integers(5, 20)), rng, relay_frac)
    cost = _edge_costs(g, "hops")[None]
    relay = np.asarray(g.relay, bool)[None]
    got = device.next_hop_lowest_id_batch(cost, relay, device="cpu")
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got[0], dijkstra_lowest_id_table_reference(rg))
    np.testing.assert_array_equal(
        got, ref_device.next_hop_lowest_id_batch(cost, relay))
    # relay=None runs kernels.ops.apsp
    np.testing.assert_array_equal(
        device.next_hop_lowest_id_batch(cost, None, device="cpu"),
        ref_device.next_hop_lowest_id_batch(cost, None))


def test_lowest_id_stacked_batch_and_blocked_selection(monkeypatch):
    rng = np.random.default_rng(1)
    graphs = [_random_graph(12, rng, relay_frac=0.8) for _ in range(4)]
    costs = np.stack([_edge_costs(g, "hops") for g, _ in graphs])
    relays = np.stack([np.asarray(g.relay, bool) for g, _ in graphs])
    dense = device.next_hop_lowest_id_batch(costs, relays, device="cpu")
    for b, (_, rg) in enumerate(graphs):
        np.testing.assert_array_equal(dense[b],
                                      dijkstra_lowest_id_table_reference(rg))
    monkeypatch.setenv("REPRO_ROUTING_BLOCK_N", "4")
    for tile in (3, 5, 12):
        monkeypatch.setenv("REPRO_ROUTING_TILE", str(tile))
        np.testing.assert_array_equal(
            device.next_hop_lowest_id_batch(costs, relays, device="cpu"),
            dense)
        np.testing.assert_array_equal(
            device.next_hop_lowest_id_batch(costs, None, device="cpu"),
            device.next_hop_lowest_id_batch(costs, np.ones_like(relays),
                                            device="cpu"))


def test_hops_tables_dense_and_blocked_match_reference(monkeypatch):
    rng = np.random.default_rng(2)
    graphs = [_random_graph(int(rng.integers(5, 24)), rng) for _ in range(4)]
    for g, rg in graphs:
        adj = _adjacency(g)
        want = np.asarray(ref_device.hops_next_hop_batch(
            jnp.asarray(adj[None])))[0]
        np.testing.assert_array_equal(want,
                                      dijkstra_lowest_id_table_reference(rg))
        dense = device.hops_next_hop_batch(torch.from_numpy(adj[None]))[0]
        assert dense.dtype == torch.int16
        np.testing.assert_array_equal(dense.numpy(), want)
        with monkeypatch.context() as m:
            m.setenv("REPRO_ROUTING_BLOCK_N", "4")
            for tile in (3, 5, 8):
                m.setenv("REPRO_ROUTING_TILE", str(tile))
                blocked = device.hops_next_hop_batch(
                    torch.from_numpy(adj[None]))[0]
                np.testing.assert_array_equal(blocked.numpy(), want)


def test_hops_tables_equal_lowest_id_tables_on_a_batch():
    rng = np.random.default_rng(4)
    graphs = [_random_graph(16, rng) for _ in range(5)]
    adj = np.stack([_adjacency(g) for g, _ in graphs])
    cost = np.where(adj, 1.0, np.inf)
    np.testing.assert_array_equal(
        device.hops_next_hop_batch(torch.from_numpy(adj)).numpy(),
        device.next_hop_lowest_id_batch(cost, device="cpu"))


@pytest.mark.parametrize("t", range(4))
def test_updown_via_device_matches_reference_rng_stream(t):
    rng = np.random.default_rng(3 + 10 * t)
    g, rg = _random_graph(int(rng.integers(6, 16)), rng,
                          relay_frac=1.0 if t % 2 == 0 else 0.75)
    ref = updown_random_table_reference(rg, seed=t)
    got = device.updown_random_table_via_device(g, seed=t, device="cpu")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, updown_random_table(g, seed=t))
    np.testing.assert_array_equal(
        got, ref_device.updown_random_table_via_device(rg, seed=t))


def test_argmax_picks_the_first_index():
    mask = torch.tensor([[False, True, True, False],
                         [True, False, False, True],
                         [False, False, False, False]])
    assert device._first_true(mask, 1).tolist() == [1, 0, 0]
    wide = torch.zeros((2, 300), dtype=torch.bool)
    wide[0, [17, 18, 250]] = True
    wide[1, [299]] = True
    assert device._first_true(wide, 1).tolist() == [17, 299]


def test_data_dependent_loops_count_their_host_syncs():
    rng = np.random.default_rng(5)
    g, _ = _random_graph(10, rng)
    before = device.host_syncs()
    device.hops_next_hop_batch(torch.from_numpy(_adjacency(g)[None]))
    device.updown_random_table_via_device(g, device="cpu")
    after = device.host_syncs()
    assert after["bfs"] > before["bfs"]
    assert after["updown"] > before["updown"]


def test_hierarchical_auto_matches_reference():
    rng = np.random.default_rng(6)
    g, _ = _random_graph(24, rng)
    adj = _adjacency(g)
    clusters = hierarchical.band_clusters(24, 6)
    for cl, frac in ((None, 0.5), (clusters, 1.0)):
        want = ref_hier.hops_next_hop_auto(adj, cl, frac)
        got = hierarchical.hops_next_hop_auto(adj, cl, frac, device="cpu")
        np.testing.assert_array_equal(got, want)
