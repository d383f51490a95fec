"""The port's population sharding (``devices=``) on the CPU: the
counterparts of ``tests/test_multidevice.py``.

A device list may repeat a device, as XLA's forced host device count
repeats the host: ``devices=["cpu"] * k`` cuts every population into k
equal contiguous shards, each with its own dispatch and its own adaptive
loops. Tolerances: k shards bit-equal to one shard on every path (the
port's sums run in an order fixed by each design's shape, so a shard of one
row gives the bits it gives in any batch); the port against the
reference's metrics, on one device or on its forced 4-device mesh, within
1e-5, the reference's own bound between its sharded and single-device runs.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (first: repro's modules need repro.core)
from repro.dse import DseEngine as RefEngine  # noqa: E402
from repro.opt import AdjacencySpace as RefAdjacencySpace  # noqa: E402

import repro_torch.core  # noqa: E402,F401
from repro_torch.dse import (DseEngine, ExperimentSpec,  # noqa: E402
                             expand_experiments)
from repro_torch.dse.genomes import bucket_population  # noqa: E402
from repro_torch.opt import (AdjacencySpace, ParametricSpace,  # noqa: E402
                             PopulationEvaluator)
from repro_torch.opt.algorithms import Budgets  # noqa: E402
from repro_torch.opt.runner import make_optimizer  # noqa: E402
from repro_torch.serve import (JobSpec, SearchService,  # noqa: E402
                               front_json_bytes, run_spec_solo)

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL = 1e-5
SHARDS = (2, 3, 4, 8)


def _rows(engine, space, genomes):
    res = engine.evaluate_genomes(space, genomes)
    return np.stack([res.latency, res.throughput])


def _ref_rows(n, maxd, genomes):
    return _rows(RefEngine(), RefAdjacencySpace(n_chiplets=n, max_degree=maxd),
                 genomes)


def _engine(k: int, **kw) -> DseEngine:
    return DseEngine(devices=["cpu"] * k, **kw)


# ---------------------------------------------------------------------------
# padding rows never perturb real rows (the reference's three tests)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_population_bucket_padding_is_inert(k):
    """A prefix of a population (another pad bucket) gives the same bits
    for the shared rows, and the whole population the reference's
    metrics."""
    space = AdjacencySpace(n_chiplets=12, max_degree=4)
    engine = _engine(k)
    genomes = space.sample(np.random.default_rng(0), 17)   # bucket 32
    full = _rows(engine, space, genomes)
    np.testing.assert_allclose(full, _ref_rows(12, 4, genomes), rtol=RTOL)
    for p in (1, 7, 8, 9, 16):                             # buckets 8..16
        np.testing.assert_array_equal(_rows(engine, space, genomes[:p]),
                                      full[:, :p])


@pytest.mark.parametrize("k", [1, 4])
def test_shard_multiple_bucket_padding_is_inert(k):
    """``bucket_population`` with a device-count multiple only adds
    padding rows; the metrics of real rows do not move."""
    space = AdjacencySpace(n_chiplets=10, max_degree=4)
    engine = _engine(k)
    genomes = space.sample(np.random.default_rng(1), 6)
    base = _rows(engine, space, genomes)
    np.testing.assert_allclose(base, _ref_rows(10, 4, genomes), rtol=RTOL)
    for mult in (3, 4, 5):
        bp = bucket_population(len(genomes), mult)
        assert bp % mult == 0
        padded = np.concatenate(
            [genomes, np.repeat(genomes[-1:], bp - len(genomes), axis=0)])
        got = _rows(engine, space, padded)
        np.testing.assert_array_equal(got[:, :len(genomes)], base)


try:
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=12, deadline=None)
    @given(st.integers(0, 10_000), st.integers(1, 13), st.sampled_from(SHARDS))
    def test_padding_property_prefix_eval_is_stable(seed, p, k):
        """Across random populations, prefix lengths (crossing the 8/16
        bucket boundaries) and shard counts, padding rows never perturb
        real rows, and the rows are the reference's."""
        space = AdjacencySpace(n_chiplets=9, max_degree=3)
        genomes = space.sample(np.random.default_rng(seed), 13)
        full = _rows(DseEngine(device="cpu"), space, genomes)
        np.testing.assert_allclose(full, _ref_rows(9, 3, genomes), rtol=RTOL)
        np.testing.assert_array_equal(
            _rows(_engine(k), space, genomes[:p]), full[:, :p])
except ImportError:  # pragma: no cover - hypothesis is a test extra
    pass


# ---------------------------------------------------------------------------
# k host shards == one shard, bit for bit, on every path
# ---------------------------------------------------------------------------

def _assert_same(got, want, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _assert_same_reports(got, want):
    for f in ("total_chiplet_area", "interposer_area", "power", "cost",
              "reachable_fraction"):
        np.testing.assert_array_equal(getattr(got.reports, f),
                                      getattr(want.reports, f), err_msg=f)


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("n,pop", [(12, 10), (32, 5)])
def test_adjacency_shards_equal_one_device(k, n, pop):
    """k = 8 at population 5 gives 1-row shards, at n = 32 (where a
    batched contraction's order would follow the batch size)."""
    space = AdjacencySpace(n_chiplets=n, max_degree=4)
    genomes = space.sample(np.random.default_rng(pop), pop)
    want = DseEngine(device="cpu").evaluate_genomes(space, genomes)
    got = _engine(k).evaluate_genomes(space, genomes)
    _assert_same(got, want, ("latency", "throughput"))
    _assert_same_reports(got, want)


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("F", [1, 3])
def test_fault_grid_shards_equal_one_device(k, F):
    """At F = 1 and k = 8 each shard evaluates one design."""
    space = AdjacencySpace(n_chiplets=32, max_degree=4)
    rng = np.random.default_rng(9)
    genomes = space.sample(rng, 6)
    link_fail = rng.random((F, space.genome_length)) < 0.1
    link_fail[0] = False                          # the pristine scenario
    node_fail = np.zeros((F, 32), bool)
    node_fail[-1, 4] = F > 1                      # one dead chiplet
    want = DseEngine(device="cpu").evaluate_genomes_faults_async(
        space, genomes, link_fail, node_fail).result()
    got = _engine(k).evaluate_genomes_faults_async(
        space, genomes, link_fail, node_fail).result()
    _assert_same(got, want, ("latency", "throughput", "reachable_fraction"))
    _assert_same_reports(got, want)


@pytest.mark.parametrize("k", SHARDS)
def test_parametric_shards_equal_one_device(k):
    space = ParametricSpace(topologies=("mesh", "torus"),
                            chiplet_counts=(9, 36))
    genomes = space.repair(np.random.default_rng(1).integers(0, 8, (7, 4)))
    want = DseEngine(device="cpu").evaluate_genomes(space, genomes)
    got = _engine(k).evaluate_genomes(space, genomes)
    _assert_same(got, want, ("latency", "throughput"))
    for f in ("total_chiplet_area", "interposer_area", "power", "cost"):
        np.testing.assert_array_equal(getattr(got.reports, f),
                                      getattr(want.reports, f), err_msg=f)


@pytest.fixture(scope="module")
def sweep_points():
    return expand_experiments(ExperimentSpec(
        topologies=("mesh", "torus", "kite"), chiplet_counts=(9, 36),
        traffic_patterns=("random_uniform", "hotspot"),
        routings=("dijkstra_lowest_id",)))


@pytest.mark.parametrize("k", SHARDS)
def test_evaluate_points_shards_equal_one_device(k, sweep_points):
    pts = sweep_points[:7]
    want = DseEngine(device="cpu").evaluate_points(pts)
    got = _engine(k).evaluate_points(pts)
    _assert_same(got, want, ("latency", "throughput"))


@pytest.mark.parametrize("k", SHARDS)
def test_run_shards_equal_one_device(k, sweep_points):
    """Chunks of 5, 5 and 2 designs, each padded to a multiple of k."""
    want = DseEngine(device="cpu", chunk_size=5).run(sweep_points)
    got = _engine(k, chunk_size=5).run(sweep_points)
    _assert_same(got, want, ("latency", "throughput"))
    assert got.to_rows() == want.to_rows()


# ---------------------------------------------------------------------------
# the port at 4 host shards against the reference's forced 4-device mesh
# ---------------------------------------------------------------------------

_WORKER = r"""
import json
import numpy as np
import jax
import repro.core
from repro.dse import DseEngine
from repro.opt import AdjacencySpace, ParametricSpace

assert len(jax.devices()) == 4, jax.devices()
multi = DseEngine()                                   # 4-device mesh
assert multi.n_devices == 4
space = AdjacencySpace(n_chiplets=12, max_degree=4)
genomes = space.sample(np.random.default_rng(0), 10)
r = multi.evaluate_genomes(space, genomes)
pspace = ParametricSpace(topologies=("mesh", "torus"), chiplet_counts=(9, 16))
pg = pspace.repair(np.random.default_rng(1).integers(0, 8, (10, 4)))
p = multi.evaluate_genomes(pspace, pg)
print("RESULT " + json.dumps({
    "adj": [r.latency.tolist(), r.throughput.tolist()],
    "par": [p.latency.tolist(), p.throughput.tolist()]}))
"""


@pytest.fixture(scope="module")
def reference_four_devices():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_SRC] + env.get("PYTHONPATH", "").split(os.pathsep))
    proc = subprocess.run([sys.executable, "-c", _WORKER], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return {k: np.asarray(v, np.float32)
            for k, v in json.loads(line[len("RESULT "):]).items()}


def _rel(got, want):
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), 1e-9)))


def test_four_host_shards_match_reference_four_devices(reference_four_devices):
    """The reference's ``_WORKER`` spaces and genomes: the port on
    ``["cpu"] * 4`` within 1e-5 of the reference's forced 4-device run on
    adj_lat, adj_thr, par_lat and par_thr."""
    engine = _engine(4)
    assert engine.n_devices == 4
    space = AdjacencySpace(n_chiplets=12, max_degree=4)
    r = engine.evaluate_genomes(space,
                                space.sample(np.random.default_rng(0), 10))
    pspace = ParametricSpace(topologies=("mesh", "torus"),
                             chiplet_counts=(9, 16))
    pg = pspace.repair(np.random.default_rng(1).integers(0, 8, (10, 4)))
    p = engine.evaluate_genomes(pspace, pg)
    ref = reference_four_devices
    diffs = {"adj_lat": _rel(r.latency, ref["adj"][0]),
             "adj_thr": _rel(r.throughput, ref["adj"][1]),
             "par_lat": _rel(p.latency, ref["par"][0]),
             "par_thr": _rel(p.throughput, ref["par"][1])}
    for key, val in diffs.items():
        assert val <= 1e-5, (key, val, diffs)


# ---------------------------------------------------------------------------
# the entry points above the engine
# ---------------------------------------------------------------------------

def test_nsga2_front_on_four_shards_equals_one_device():
    space = AdjacencySpace(n_chiplets=10, max_degree=4)
    states = []
    for kw in ({"device": "cpu"}, {"devices": ["cpu"] * 4}):
        ev = PopulationEvaluator(
            space, budgets=Budgets(max_interposer_area=2500.0), **kw)
        opt = make_optimizer("nsga2", space, ev, seed=3, pop_size=10)
        for _ in range(4):
            opt.step()
        states.append((opt.archive.to_dicts(), opt.state(), ev.n_evals))
    assert ev.engine.n_devices == 4
    assert states[0] == states[1]


def test_cobatched_round_over_four_shards_equals_solo():
    """Four jobs co-batched by one service whose engine shards every round
    over four host devices: each job's front, eval count and state equal
    its solo run on one device."""
    space = {"kind": "adjacency", "n_chiplets": 10, "max_degree": 4}
    specs = [JobSpec(job_id=f"j{seed}", algo=algo, generations=3,
                     pop_size=size, seed=seed, space=dict(space))
             for seed, algo, size in ((1, "nsga2", 8), (2, "sa", 5),
                                      (3, "random", 6), (4, "nsga2", 3))]
    with SearchService(devices=["cpu"] * 4) as svc:
        assert svc.engine.n_devices == 4
        for spec in specs:
            svc.submit(spec)
        jobs = [svc.wait(spec.job_id, 300) for spec in specs]
    for job, spec in zip(jobs, specs):
        assert job.status == "done", (job.job_id, job.status, job.reason)
        solo_opt, solo_rows = run_spec_solo(spec, device="cpu")
        assert front_json_bytes(job.result_rows) == front_json_bytes(
            solo_rows)
        assert job.n_evals == solo_opt.evaluator.n_evals
        assert job.optimizer.state() == solo_opt.state()


def test_device_and_devices_together_raise():
    with pytest.raises(ValueError, match="not both"):
        DseEngine(device="cpu", devices=["cpu", "cpu"])


def test_devices_attribute_and_first_device():
    engine = DseEngine(devices=["cpu"] * 3)
    assert engine.devices == [torch.device("cpu")] * 3
    assert engine.device == torch.device("cpu") and engine.n_devices == 3
    assert DseEngine(device="cpu").devices == [torch.device("cpu")]
