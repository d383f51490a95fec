"""The port's batched sweep engine against ``repro.dse`` on the CPU, the
same JAX-encoded batch through both evaluators, checkpoint resume, and
batch invariance. Tolerance: latency and throughput within rtol 1e-5 (f32
sums in another order); resume and batch invariance bit for bit."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (first: repro.dse needs repro.core loaded)
import repro.dse as ref_dse

from repro_torch.dse import (DseEngine, ExperimentSpec, batch_from_numpy,
                             encode_designs, expand_experiments)

RTOL = 1e-5
SPEC = dict(topologies=("mesh", "hexatorus", "kite", "double_butterfly"),
            chiplet_counts=(16, 36),
            traffic_patterns=("random_uniform", "hotspot"),
            routings=("dijkstra_lowest_id", "updown_random"))


@pytest.fixture(scope="module")
def points():
    return expand_experiments(ExperimentSpec(**SPEC))


@pytest.fixture(scope="module")
def reference():
    pts = ref_dse.expand_experiments(ref_dse.ExperimentSpec(**SPEC))
    return pts, ref_dse.DseEngine(chunk_size=12).run(pts)


def _close(got, want):
    np.testing.assert_allclose(got.latency, want.latency, rtol=RTOL)
    np.testing.assert_allclose(got.throughput, want.throughput, rtol=RTOL)


def test_run_matches_reference(points, reference):
    got = DseEngine(chunk_size=12, device="cpu").run(points)
    _close(got, reference[1])
    assert [r["index"] for r in got.to_rows()] == [
        r["index"] for r in reference[1].to_rows()]


def test_readme_sweep_matches_reference():
    """``examples/dse_sweep.py``'s 120-point sweep, chunk 60, row by row."""
    spec = dict(topologies=("mesh", "torus", "folded_torus",
                            "flattened_butterfly", "hexamesh", "hexatorus",
                            "sid_mesh", "octamesh", "kite", "double_butterfly"),
                chiplet_counts=(16, 36, 64),
                traffic_patterns=("random_uniform", "hotspot"),
                routings=("dijkstra_lowest_id", "updown_random"))
    got = DseEngine(chunk_size=60, device="cpu").run(
        expand_experiments(ExperimentSpec(**spec)))
    want = ref_dse.DseEngine(chunk_size=60).run(
        ref_dse.expand_experiments(ref_dse.ExperimentSpec(**spec)))
    assert len(got.points) == 120
    _close(got, want)


@pytest.mark.parametrize("n_pad,round_hops", [(None, False), (96, True)])
def test_evaluate_points_matches_reference(points, reference, n_pad,
                                           round_hops):
    subset = points[8:24]
    ref_subset = reference[0][8:24]
    got = DseEngine(device="cpu").evaluate_points(subset, n_pad=n_pad,
                                                  round_hops=round_hops)
    want = ref_dse.DseEngine().evaluate_points(ref_subset, n_pad=n_pad,
                                               round_hops=round_hops)
    _close(got, want)


def test_same_encoded_batch_through_both_evaluators(reference):
    ref_points = reference[0][:20]
    enc = ref_dse.encode_designs(ref_points, validate=False)
    want = ref_dse.DseEngine().evaluate_batch(enc)
    batch = batch_from_numpy(enc.next_hop, enc.step_cost, enc.node_weight,
                             enc.adj_bw, enc.traffic, enc.max_hops,
                             points=enc.points, device="cpu")
    got = DseEngine(device="cpu").evaluate_batch(batch)
    _close(got, want)


def test_port_encoding_equals_reference_encoding(points, reference):
    enc = ref_dse.encode_designs(reference[0][:20], validate=False)
    batch = encode_designs(points[:20], validate=False, device="cpu")
    for field in ("next_hop", "step_cost", "node_weight", "adj_bw",
                  "traffic"):
        np.testing.assert_array_equal(getattr(batch, field).numpy(),
                                      getattr(enc, field))
    assert batch.max_hops == enc.max_hops


class _Killed(Exception):
    pass


def test_resume_after_kill_equals_uninterrupted_run(points, tmp_path,
                                                    monkeypatch):
    whole = DseEngine(chunk_size=10, device="cpu").run(points)

    ckpt = str(tmp_path / "sweep.jsonl")
    engine = DseEngine(chunk_size=10, device="cpu", checkpoint_path=ckpt)
    real = DseEngine._finish_chunk
    calls = []

    def finish_then_die(self, batch, results):
        if calls:
            raise _Killed
        calls.append(1)
        real(self, batch, results)

    monkeypatch.setattr(DseEngine, "_finish_chunk", finish_then_die)
    with pytest.raises(_Killed):
        engine.run(points)
    monkeypatch.setattr(DseEngine, "_finish_chunk", real)
    with open(ckpt) as f:
        assert len([json.loads(line) for line in f]) == 10

    resumed = DseEngine(chunk_size=10, device="cpu", checkpoint_path=ckpt)
    assert len(resumed._done) == 10
    res = resumed.run(points)
    np.testing.assert_array_equal(res.latency, whole.latency)
    np.testing.assert_array_equal(res.throughput, whole.throughput)


def test_one_design_alone_equals_it_inside_a_batch(points):
    engine = DseEngine(device="cpu")
    n = encode_designs(points, validate=False, device="cpu").n
    together = engine.evaluate_points(points, n_pad=n)
    for i in (0, 5, len(points) - 1):
        alone = engine.evaluate_points([points[i]], n_pad=n)
        assert alone.latency[0] == together.latency[i]
        assert alone.throughput[0] == together.throughput[i]
