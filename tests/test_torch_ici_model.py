"""The port's pod interconnect model and layout advisor
(``repro_torch.core.ici_model``, ``repro_torch.sharding.autoshard``)
against the reference on the CPU.

Both packages get the same link bandwidth, the reference's
``TPU_V5E_ICI_LINK_BW`` (the port carries no TPU constant). Every
collective kind on both axes of the 4 x 4 torus and mesh agrees with the
reference within rtol 1e-5 field by field; the traffic matrices are
equal; the reference's six properties of the model hold in the port; and
``rank_layouts`` ranks glm4-9b's and olmoe-1b-7b's candidate layouts as
the reference does on the 16 x 16 pod, with totals within rtol 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401
from repro.configs import get_config as ref_get_config
from repro.core import ici_model as ref_ici
from repro.core.ici_model import TPU_V5E_ICI_LINK_BW as BW
from repro.sharding import autoshard as ref_autoshard

import repro_torch.core  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.core import ici_model
from repro_torch.core.ici_model import (NVLINK4_LINK_BW,
                                        analytic_collective_time,
                                        collective_traffic,
                                        estimate_collective, tpu_pod_design)
from repro_torch.sharding import autoshard

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all")


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_estimates_match_reference_at_4x4(kind, wrap):
    for axis in ("data", "model"):
        for b in (1e6, 4e9):
            got = estimate_collective(kind, axis, b, rows=4, cols=4,
                                      wrap=wrap, link_bw=BW, device="cpu")
            want = ref_ici.estimate_collective(kind, axis, b, rows=4, cols=4,
                                               wrap=wrap, link_bw=BW)
            for f in dataclasses.fields(want):
                g, w = getattr(got, f.name), getattr(want, f.name)
                if isinstance(w, str):
                    assert g == w
                else:
                    assert g == pytest.approx(w, rel=1e-5), (axis, f.name)


@pytest.mark.parametrize("kind", KINDS)
def test_traffic_and_analytic_times_equal_reference(kind):
    for rows, cols in ((4, 4), (16, 16), (2, 8)):
        for axis in ("data", "model"):
            np.testing.assert_array_equal(
                collective_traffic(kind, rows, cols, axis, 3e8),
                ref_ici.collective_traffic(kind, rows, cols, axis, 3e8))
    for k in (1, 2, 16):
        assert analytic_collective_time(kind, 3e8, k, BW) == \
            ref_ici.analytic_collective_time(kind, 3e8, k, BW)


def test_pod_design_is_torus():
    design, arrays, g = tpu_pod_design(4, 4, link_bw=BW)
    assert g.n == 16
    assert (g.degree() == 4).all()
    assert (g.adj_bw[np.isfinite(g.adj_lat)] == BW).all()
    _, ref_arrays, _ = ref_ici.tpu_pod_design(4, 4, link_bw_bytes=BW)
    for name in ("next_hop", "step_cost", "node_weight", "adj_bw"):
        np.testing.assert_array_equal(getattr(arrays, name),
                                      getattr(ref_arrays, name))


def test_collective_traffic_ring_volume():
    rows = cols = k = 4
    b = 1e9
    t = collective_traffic("all_gather", rows, cols, "data", b)
    assert t.sum() == pytest.approx(rows * k * b * (k - 1) / k)


def test_ring_allgather_proxy_matches_analytic_on_torus():
    est = estimate_collective("all_gather", "data", 4e9, rows=4, cols=4,
                              link_bw=BW, device="cpu")
    assert est.proxy_s == pytest.approx(est.analytic_s, rel=1e-6)
    assert est.proxy_sustained_fraction == pytest.approx(1.0)


def test_allreduce_twice_allgather():
    ag = analytic_collective_time("all_gather", 1e9, 16)
    ar = analytic_collective_time("all_reduce", 1e9, 16)
    assert ar == pytest.approx(2 * ag)


def test_mesh_worse_than_torus_for_rings():
    torus = estimate_collective("all_gather", "data", 4e9, rows=4, cols=4,
                                wrap=True, device="cpu")
    mesh = estimate_collective("all_gather", "data", 4e9, rows=4, cols=4,
                               wrap=False, device="cpu")
    assert mesh.proxy_s == pytest.approx(2 * torus.proxy_s, rel=0.2)


def test_all_to_all_congestion_detected():
    est = estimate_collective("all_to_all", "data", 8e9, rows=4, cols=4,
                              device="cpu")
    assert est.proxy_s > 0 and np.isfinite(est.proxy_s)


def test_link_bandwidth_is_the_h100_nvlink_default():
    """The port prices with one NVLink 4 link of an H100 SXM5 (25 GB/s a
    direction) unless told otherwise, and carries no TPU rate."""
    assert NVLINK4_LINK_BW == 25e9
    assert not [n for n in dir(ici_model) if "TPU" in n]
    a = estimate_collective("all_gather", "data", 4e9, rows=4, cols=4,
                            device="cpu")
    b = estimate_collective("all_gather", "data", 4e9, rows=4, cols=4,
                            link_bw=2 * NVLINK4_LINK_BW, device="cpu")
    assert a.analytic_s == pytest.approx(2 * b.analytic_s)
    assert a.proxy_s == pytest.approx(2 * b.proxy_s, rel=1e-6)


def test_estimate_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        estimate_collective("all_gather", "data", 1e6, rows=4, cols=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autoshard.rank_layouts(get_config("glm4-9b"), 256, 4096,
                               {"data": 16, "model": 16})


@pytest.mark.parametrize("arch", ["glm4-9b", "olmoe-1b-7b"])
def test_rank_layouts_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    mesh = {"data": 16, "model": 16}
    got = autoshard.rank_layouts(cfg, 256, 4096, mesh, link_bw=BW,
                                 device="cpu")
    # the reference's link bandwidth is its module default
    want = ref_autoshard.rank_layouts(ref_cfg, 256, 4096, mesh)
    assert [r["rules"] for r in got] == [r["rules"] for r in want]
    for g, w in zip(got, want):
        assert g["total_s"] == pytest.approx(w["total_s"], rel=1e-5)
        assert set(g["per_tag"]) == set(w["per_tag"])
        for tag in w["per_tag"]:
            assert g["per_tag"][tag] == pytest.approx(w["per_tag"][tag],
                                                      rel=1e-5)
    for name in ("default", "seq_parallel"):
        assert [dataclasses.astuple(d) for d in
                autoshard.training_collective_demand(cfg, 256, 4096, 16, 16,
                                                     name)] == \
            [dataclasses.astuple(d) for d in
             ref_autoshard.training_collective_demand(ref_cfg, 256, 4096, 16,
                                                      16, name)]
