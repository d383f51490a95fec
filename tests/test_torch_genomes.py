"""The port's genome cost function (``repro_torch.dse.genomes`` behind
``DseEngine.evaluate_genomes``) and search spaces on the CPU against the
JAX package. Tolerances: repaired genomes and reports exactly equal;
latency and throughput within rtol 1e-5 (f32 sums in another order, the
reference's own bound between its host and device paths); a genome alone
bit-equal to it inside a population."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (first: repro's modules need repro.core loaded)
from repro.dse import genomes as ref_genomes
from repro.dse.engine import DseEngine as RefEngine
from repro.opt import AdjacencySpace as RefAdjacencySpace
from repro.opt import ParametricSpace as RefParametricSpace

import repro_torch.core  # noqa: F401
from repro_torch.dse import DseEngine, genomes
from repro_torch.opt import AdjacencySpace, ParametricSpace

RTOL = 1e-5
REPORT_FIELDS = ("total_chiplet_area", "interposer_area", "power", "cost",
                 "reachable_fraction")


def _assert_matches(got, want):
    np.testing.assert_allclose(got.latency, want.latency, rtol=RTOL)
    np.testing.assert_allclose(got.throughput, want.throughput, rtol=RTOL)
    for f in REPORT_FIELDS:
        np.testing.assert_array_equal(getattr(got.reports, f),
                                      getattr(want.reports, f), err_msg=f)


@pytest.mark.parametrize("n,maxd", [(8, 2), (10, 3), (16, 5)])
def test_repair_bit_identical_to_reference(n, maxd):
    space = AdjacencySpace(n_chiplets=n, max_degree=maxd)
    ref = RefAdjacencySpace(n_chiplets=n, max_degree=maxd)
    rng = np.random.default_rng(n * maxd)
    G = space.genome_length
    genomes_ = np.concatenate([
        (rng.random((12, G)) < 0.15).astype(np.int64),   # mostly disconnected
        (rng.random((12, G)) < 0.8).astype(np.int64),    # mostly over the cap
        rng.integers(0, 5, (4, G)),                      # non-binary genes
        np.zeros((1, G), np.int64), np.ones((1, G), np.int64)])
    got = space.repair(genomes_)
    np.testing.assert_array_equal(got, ref.repair(genomes_))
    for row, g in zip(got, genomes_):
        np.testing.assert_array_equal(row, ref._repair_one(g % 2))
    # a join may exceed the cap by one, so a second repair may drop links
    np.testing.assert_array_equal(space.repair(got), ref.repair(got))


def test_spaces_sample_and_decode_like_the_reference():
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    space, ref = AdjacencySpace(12, 4), RefAdjacencySpace(12, 4)
    np.testing.assert_array_equal(space.sample(rng_a, 5),
                                  ref.sample(rng_b, 5))
    g = space.sample(rng_a, 2)
    assert [pt.links for pt in space.decode(g)] == [
        pt.links for pt in ref.decode(g)]
    pspace, pref = ParametricSpace(), RefParametricSpace()
    np.testing.assert_array_equal(pspace.enumerate_genomes(),
                                  pref.enumerate_genomes())
    np.testing.assert_array_equal(pspace.cardinalities, pref.cardinalities)


@pytest.mark.parametrize("n,maxd,seed", [(10, 4, 3), (16, 5, 7)])
def test_adjacency_metrics_match_reference(n, maxd, seed):
    space = AdjacencySpace(n_chiplets=n, max_degree=maxd)
    ref_space = RefAdjacencySpace(n_chiplets=n, max_degree=maxd)
    pop = ref_space.sample(np.random.default_rng(seed), 6)
    want = RefEngine().evaluate_genomes(ref_space, pop)
    got = DseEngine(device="cpu").evaluate_genomes(space, pop)
    _assert_matches(got, want)


def test_tiled_tier_matches_reference(monkeypatch):
    """Blocked routing and the load-propagation slab form, forced by
    lowering their thresholds below n."""
    monkeypatch.setenv("REPRO_ROUTING_BLOCK_N", "8")
    monkeypatch.setenv("REPRO_ROUTING_TILE", "5")
    monkeypatch.setenv("REPRO_LOAD_PROP_FUSED_N", "8")
    monkeypatch.setenv("REPRO_LOAD_PROP_TILE", "3")
    space = AdjacencySpace(n_chiplets=13, max_degree=4)
    ref_space = RefAdjacencySpace(n_chiplets=13, max_degree=4)
    pop = ref_space.sample(np.random.default_rng(11), 5)
    want = RefEngine().evaluate_genomes(ref_space, pop)
    got = DseEngine(device="cpu").evaluate_genomes(space, pop)
    _assert_matches(got, want)


def test_parametric_metrics_match_reference():
    kw = dict(topologies=("mesh", "torus", "hexamesh", "shg", "kite"),
              chiplet_counts=(16, 20))
    space, ref_space = ParametricSpace(**kw), RefParametricSpace(**kw)
    pop = ref_space.sample(np.random.default_rng(2), 10)
    want = RefEngine().evaluate_genomes(ref_space, pop)
    got = DseEngine(device="cpu").evaluate_genomes(space, pop)
    np.testing.assert_allclose(got.latency, want.latency, rtol=RTOL)
    np.testing.assert_allclose(got.throughput, want.throughput, rtol=RTOL)
    for f in REPORT_FIELDS:
        np.testing.assert_array_equal(getattr(got.reports, f),
                                      getattr(want.reports, f), err_msg=f)


@pytest.mark.parametrize("kind", ["adjacency", "parametric"])
def test_pipeline_evaluate_matches_reference(kind):
    """``make_pipeline(space, device).evaluate(genomes)`` on either kind of
    space against the reference's pipeline ``evaluate`` (ROADMAP Queue C:
    the parametric pipeline had only ``evaluate_async``)."""
    if kind == "adjacency":
        kw = dict(n_chiplets=12, max_degree=4)
        space, ref_space = AdjacencySpace(**kw), RefAdjacencySpace(**kw)
    else:
        kw = dict(topologies=("mesh", "torus", "shg", "kite"),
                  chiplet_counts=(16, 20))
        space, ref_space = ParametricSpace(**kw), RefParametricSpace(**kw)
    pop = ref_space.sample(np.random.default_rng(11), 9)
    want = RefEngine()._genome_pipeline(ref_space).evaluate(pop)
    pipeline = genomes.make_pipeline(space, "cpu")
    got = pipeline.evaluate(pop)
    _assert_matches(got, want)
    assert got.latency.dtype == np.float32 and len(got.latency) == len(pop)
    pending = pipeline.evaluate_async(pop).result()
    np.testing.assert_array_equal(got.latency, pending.latency)
    np.testing.assert_array_equal(got.throughput, pending.throughput)


@pytest.mark.parametrize("kind", ["adjacency", "parametric"])
def test_genome_alone_equals_it_in_its_population(kind):
    if kind == "adjacency":
        space = AdjacencySpace(n_chiplets=14, max_degree=4)
    else:
        space = ParametricSpace(topologies=("mesh", "torus", "kite"),
                                chiplet_counts=(16,))
    pop = space.sample(np.random.default_rng(9), 20)
    engine = DseEngine(device="cpu")
    together = engine.evaluate_genomes(space, pop)
    for i in (0, 7, 19):
        alone = engine.evaluate_genomes(space, pop[i:i + 1])
        assert alone.latency[0] == together.latency[i]
        assert alone.throughput[0] == together.throughput[i]


def test_async_equals_sync_and_pipeline_is_cached():
    space = AdjacencySpace(n_chiplets=10, max_degree=3)
    pop = space.sample(np.random.default_rng(4), 9)
    engine = DseEngine(device="cpu")
    pending = engine.evaluate_genomes_async(space, pop)
    sync = engine.evaluate_genomes(space, pop)
    res = pending.result()
    assert pending.result() is res
    np.testing.assert_array_equal(res.latency, sync.latency)
    np.testing.assert_array_equal(res.throughput, sync.throughput)
    assert engine._genome_pipeline(space) is engine._genome_pipeline(space)
    assert engine.supports_genomes(space)


def test_spaces_without_a_device_path():
    engine = DseEngine(device="cpu")
    space = AdjacencySpace(n_chiplets=8, routing="updown_random")
    assert not engine.supports_genomes(space)
    with pytest.raises(ValueError, match="evaluate_points"):
        engine.evaluate_genomes(space, space.sample(np.random.default_rng(0),
                                                    2))
    capped = AdjacencySpace(n_chiplets=8, max_degree=2)
    with pytest.raises(ValueError, match="repair"):
        engine.evaluate_genomes(capped, np.ones((1, capped.genome_length),
                                                np.int64))


def test_buckets_match_reference():
    for size in (1, 7, 8, 9, 24, 64, 65):
        assert genomes.bucket_population(size) == \
            ref_genomes.bucket_population(size)
        assert genomes.bucket_population(size, 3) == \
            ref_genomes.bucket_population(size, 3)
    for n in (3, 8, 9, 16, 17, 100, 256, 576):
        assert genomes.node_bucket(n) == ref_genomes.node_bucket(n)


def _oracle(design, traffic):
    """The reference's f64 oracle (``repro.core.reference``: per-pair route
    walks) on the reference's own graph and routing table."""
    from repro.core.graph import build_graph
    from repro.core.reference import latency_reference, throughput_reference
    from repro.routing.tables import build_routing_table

    g = build_graph(design)
    nh = build_routing_table(g, design.routing, design.routing_metric,
                             design.seed)
    return latency_reference(g, nh, traffic), throughput_reference(g, nh,
                                                                   traffic)


def test_genome_path_within_1e6_of_the_f64_oracle_at_n_32():
    """At n = 32 the reference's f32 sums drift about 1.4e-5 from the f64
    oracle; the port's fixed-order sums stay within rtol 1e-6 of it."""
    space = AdjacencySpace(32, 8)
    pop = space.sample(np.random.default_rng(32), 16)
    got = DseEngine(device="cpu").evaluate_genomes(space, pop)
    want = np.array([_oracle(pt.build(), pt.traffic())
                     for pt in RefAdjacencySpace(32, 8).decode(pop)])
    np.testing.assert_allclose(got.latency, want[:, 0], rtol=1e-6)
    np.testing.assert_allclose(got.throughput, want[:, 1], rtol=1e-6)


def test_single_design_within_1e6_of_the_f64_oracle_at_256_chiplets():
    from repro.topologies import make_design as ref_make_design
    from repro.traffic import make_traffic as ref_make_traffic

    from repro_torch.core import evaluate_design
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic

    rep = evaluate_design(make_design("mesh", 256),
                          make_traffic("random_uniform", 256), device="cpu")
    lat, thr = _oracle(ref_make_design("mesh", 256),
                       ref_make_traffic("random_uniform", 256))
    np.testing.assert_allclose(rep.latency, lat, rtol=1e-6)
    np.testing.assert_allclose(rep.throughput, thr, rtol=1e-6)
