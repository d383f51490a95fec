"""The port's pictures (``repro_torch.core.visualize``) against the JAX
package's ``repro.core.visualize``.

Tolerances: none. ``design_to_svg`` is the same numpy and string work, so
its text must be byte-equal to the reference's; ``latency_vs_load`` rows
come from integer cycle models and must equal the reference's field for
field on every backend (numpy, C, and the torch loop on the CPU) and on
the per-flit ``cycle`` engine.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (first: repro's modules need repro.core)
from repro.core import visualize as ref_visualize  # noqa: E402
from repro.sim import SimConfig as RefSimConfig  # noqa: E402
from repro.topologies import make_design as ref_make_design  # noqa: E402
from repro.traffic import make_traffic as ref_make_traffic  # noqa: E402

import repro_torch.core  # noqa: E402,F401
from repro_torch.core import visualize  # noqa: E402
from repro_torch.core.design import Packaging  # noqa: E402
from repro_torch.sim import SimConfig  # noqa: E402
from repro_torch.topologies import TOPOLOGIES, make_design  # noqa: E402
from repro_torch.traffic import make_traffic  # noqa: E402


def _kw(topology: str, n: int) -> dict:
    if topology == "custom":
        return {"edges": [(i, (i + 1) % n) for i in range(n)]
                + [(0, n // 2)]}
    return {}


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_svg_byte_equal_to_reference(topology, tmp_path):
    n = 16
    kw = _kw(topology, n)
    path = str(tmp_path / "d.svg")
    svg = visualize.design_to_svg(make_design(topology, n, **kw), path)
    assert svg == ref_visualize.design_to_svg(ref_make_design(topology, n,
                                                              **kw))
    with open(path) as f:
        assert f.read() == svg


@pytest.mark.parametrize("scale", [3.0, 8.0, 12.5])
def test_svg_byte_equal_across_scales_and_link_routing(scale):
    from repro.core.design import Packaging as RefPackaging

    for routing in ("manhattan", "euclidean"):
        got = visualize.design_to_svg(
            make_design("hexamesh", 36,
                        packaging=Packaging(link_routing=routing)),
            scale=scale)
        want = ref_visualize.design_to_svg(
            ref_make_design("hexamesh", 36,
                            packaging=RefPackaging(link_routing=routing)),
            scale=scale)
        assert got == want


_CFG = dict(packet_size_flits=1, warmup_cycles=200, measure_cycles=600,
            drain_cycles=800)
_RATES = (0.02, 0.1, 0.3, 0.8)


def _ref_rows(topology: str, n: int, pattern: str, engine: str = "fast"):
    return ref_visualize.latency_vs_load(
        ref_make_design(topology, n), ref_make_traffic(pattern, n),
        rates=_RATES, config=RefSimConfig(**_CFG), engine=engine)


@pytest.mark.parametrize("backend", ["numpy", "c", "torch"])
@pytest.mark.parametrize("topology,n,pattern", [
    ("mesh", 9, "random_uniform"), ("torus", 16, "transpose"),
    ("kite", 16, "hotspot")])
def test_latency_vs_load_rows_equal_reference(backend, topology, n, pattern):
    if backend == "c":
        from repro_torch.sim._ckernel import get_kernel
        if get_kernel() is None:
            pytest.skip("no C compiler (cc) on PATH")
    rows = visualize.latency_vs_load(
        make_design(topology, n), make_traffic(pattern, n), rates=_RATES,
        config=SimConfig(**_CFG), backend=backend, device="cpu")
    assert rows == _ref_rows(topology, n, pattern)
    assert rows[0]["stable"] and rows[0]["latency"] > 0


def test_latency_vs_load_cycle_engine_equals_reference():
    rows = visualize.latency_vs_load(
        make_design("mesh", 9), make_traffic("random_uniform", 9),
        rates=_RATES, config=SimConfig(**_CFG), engine="cycle")
    assert rows == _ref_rows("mesh", 9, "random_uniform", engine="cycle")


def test_latency_vs_load_default_config_and_backend():
    """The reference's defaults (rates, config, backend 'auto')."""
    got = visualize.latency_vs_load(make_design("mesh", 4),
                                    make_traffic("random_uniform", 4))
    want = ref_visualize.latency_vs_load(ref_make_design("mesh", 4),
                                         ref_make_traffic("random_uniform",
                                                          4))
    assert got == want


def test_latency_vs_load_runs_on_the_host_unless_torch_is_asked(monkeypatch):
    """A recorded difference in kind (ROADMAP Queue C): like
    ``FastSim.run_batch``, ``latency_vs_load`` runs the cycle loop on the
    host (C, else numpy) unless the caller passes ``backend="torch"``,
    whatever ``device`` says; only the torch backend reads ``device``."""
    from repro_torch.sim import simfast_torch

    calls = []

    def torch_loop(sim, rates, cfg, device=None):
        calls.append(device)
        raise RuntimeError("the torch backend ran")

    monkeypatch.setattr(simfast_torch, "run_batch_torch", torch_loop)
    args = (make_design("mesh", 4), make_traffic("random_uniform", 4))
    kw = dict(rates=_RATES, config=SimConfig(**_CFG))
    want = ref_visualize.latency_vs_load(
        ref_make_design("mesh", 4), ref_make_traffic("random_uniform", 4),
        rates=_RATES, config=RefSimConfig(**_CFG))
    assert visualize.latency_vs_load(*args, **kw) == want
    assert visualize.latency_vs_load(*args, device="cuda", **kw) == want
    assert calls == []
    with pytest.raises(RuntimeError, match="the torch backend ran"):
        visualize.latency_vs_load(*args, backend="torch", **kw)
    assert calls == [None]
