"""The port's simulator (``repro_torch.sim``) on the CPU against the JAX
package's ``repro.sim``, and its torch backend against its numpy backend.

Tolerances: none. The simulators are integer cycle models whose only floats
are sums of whole cycle counts, so every comparison is exact:

* the port's ``CycleSim`` and ``FastSim`` (numpy backend) give ``SimStats``
  equal to the reference's on the same designs, traffic and seeds (the
  cases of ``tests/test_simfast.py`` and ``tests/test_cyclesim.py`` at their
  sizes);
* ``run_batch(backend="torch", device="cpu")`` gives every ``SimStats``
  field of the numpy backend, at B = 1 and B = 5, on a deadlocking ring and
  in the watchdog cases;
* the batched saturation search equals the sequential one and the
  reference's, on the numpy and the torch backends;
* the C backend equals numpy where ``cc`` is present.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (first: repro's modules need repro.core)
from repro import sim as ref_sim  # noqa: E402
from repro.sim import simfast_jax as ref_simfast_jax  # noqa: E402
from repro.topologies import make_design as ref_make_design  # noqa: E402
from repro.traffic import make_traffic as ref_make_traffic  # noqa: E402

import repro_torch.core  # noqa: E402,F401
from repro_torch import sim  # noqa: E402
from repro_torch.sim import (CycleSim, FastSim, SaturationResult,  # noqa: E402
                             SimConfig, fast_sim_from_design, make_sim,
                             saturation_throughput,
                             saturation_throughput_batched, sim_from_design)
from repro_torch.sim import simfast_torch  # noqa: E402
from repro_torch.topologies import make_design  # noqa: E402
from repro_torch.traffic import make_traffic  # noqa: E402


def _fast_cfg(seed=0, psize=1):
    return dict(packet_size_flits=psize, warmup_cycles=300,
                measure_cycles=1200, drain_cycles=2000, seed=seed)


_BATCH_CFG = dict(packet_size_flits=2, warmup_cycles=200, measure_cycles=800,
                  drain_cycles=1500, seed=0)


def _both(topo, n, pattern, cfg_kw, engine, traffic_seed=None):
    """The same design, traffic and config through the port and the
    reference: (port sim, reference sim)."""
    tkw = {} if traffic_seed is None else {"seed": traffic_seed}
    port = make_sim(make_design(topo, n), make_traffic(pattern, n, **tkw),
                    SimConfig(**cfg_kw), engine=engine)
    ref = ref_sim.make_sim(ref_make_design(topo, n),
                           ref_make_traffic(pattern, n, **tkw),
                           ref_sim.SimConfig(**cfg_kw), engine=engine)
    return port, ref


def _same(a, b):
    """Port and reference SimStats field for field (different classes)."""
    return a.__dict__ == b.__dict__


# ---------------------------------------------------------------------------
# the port's engines equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("psize", [1, 4])
def test_single_flow_exact_vs_oracle_analytic_and_reference(psize):
    n = 16
    t = np.zeros((n, n))
    t[0, n - 1] = 1.0
    kw = dict(packet_size_flits=psize, warmup_cycles=200,
              measure_cycles=1000, drain_cycles=1500, seed=2)
    cfg = SimConfig(**kw)
    ref = sim_from_design(make_design("mesh", n), t, cfg)
    fast = fast_sim_from_design(make_design("mesh", n), t, cfg)
    sr, sf = ref.run(0.004), fast.run(0.004)
    u, d, lat = 0, n - 1, 0
    while u != d:
        v = int(ref.next_hop[u, d])
        lat += int(ref.node_delay[u] + ref.hop_delay[u, v])
        u = v
    lat += int(ref.node_delay[d]) + (psize - 1)
    assert sr.packets_measured > 0
    assert sr.avg_packet_latency == sf.avg_packet_latency == lat
    ref_cfg = ref_sim.SimConfig(**kw)
    assert _same(sr, ref_sim.sim_from_design(
        ref_make_design("mesh", n), t, ref_cfg).run(0.004))
    assert _same(sf, ref_sim.fast_sim_from_design(
        ref_make_design("mesh", n), t, ref_cfg).run(0.004))


# (topology, n, pattern, traffic seed, config, rate): the runs of
# tests/test_cyclesim.py and tests/test_simfast.py that are cheap on CycleSim
_ORACLE_CASES = [
    ("mesh", 16, "random_uniform", None, _fast_cfg(), 0.004),
    ("torus", 16, "transpose", None, _fast_cfg(seed=3), 0.004),
    ("mesh", 9, "random_uniform", None, _fast_cfg(psize=4), 0.004),
    ("torus", 16, "random_uniform", None, _fast_cfg(seed=1), 0.05),
    ("mesh", 16, "random_uniform", None,
     dict(packet_size_flits=2, warmup_cycles=300, measure_cycles=6000,
          drain_cycles=2000, seed=0), 0.02),
]


@pytest.mark.parametrize("topo,n,pattern,tseed,cfg,rate", _ORACLE_CASES)
def test_cyclesim_equals_reference(topo, n, pattern, tseed, cfg, rate):
    port, ref = _both(topo, n, pattern, cfg, "cycle", tseed)
    assert isinstance(port, CycleSim) and not isinstance(port, FastSim)
    got = port.run(rate)
    assert got.packets_measured > 0
    assert _same(got, ref.run(rate))


def test_cyclesim_watchdog_equals_reference():
    hop = np.full((2, 2), np.inf)
    hop[0, 1] = hop[1, 0] = 5000.0
    tp = np.zeros((2, 2))
    tp[0, 1] = 1.0
    for dc, drain, expect in ((50, 200, True), (50, 30, False),
                              (6000, 20000, False)):
        kw = dict(packet_size_flits=1, warmup_cycles=0, measure_cycles=10,
                  drain_cycles=drain, deadlock_cycles=dc, seed=0)
        args = (np.array([[0, 1], [0, 1]]), hop, np.zeros(2), tp)
        got = CycleSim(*args, config=SimConfig(**kw)).run(1.0)
        want = ref_sim.CycleSim(*args, config=ref_sim.SimConfig(**kw)).run(
            1.0)
        assert got.deadlock == expect
        assert _same(got, want)


# (topology, n, pattern, traffic seed, config, rates): the FastSim runs of
# tests/test_simfast.py
_FAST_CASES = [
    ("mesh", 16, "random_uniform", None, _fast_cfg(), [0.004]),
    ("torus", 16, "transpose", None, _fast_cfg(seed=3), [0.004]),
    ("mesh", 9, "random_uniform", None, _fast_cfg(psize=4), [0.004]),
    ("torus", 16, "random_uniform", None, _fast_cfg(seed=1), [0.05]),
    ("mesh", 16, "hotspot", 0, _fast_cfg(seed=1, psize=4), [0.9]),
    ("mesh", 16, "random_uniform", None, _BATCH_CFG, [0.05, 0.15, 0.3]),
    ("mesh", 16, "random_uniform", 0,
     dict(packet_size_flits=4, warmup_cycles=200, measure_cycles=700,
          drain_cycles=1200, seed=0), [0.04, 0.3, 0.8]),
    ("mesh", 16, "hotspot", 0,
     dict(packet_size_flits=2, warmup_cycles=200, measure_cycles=700,
          drain_cycles=1200, seed=1), [0.04, 0.3, 0.8]),
]


@pytest.mark.parametrize("topo,n,pattern,tseed,cfg,rates", _FAST_CASES)
def test_fastsim_numpy_equals_reference(topo, n, pattern, tseed, cfg, rates):
    port, ref = _both(topo, n, pattern, cfg, "fast", tseed)
    got = port.run_batch(rates, backend="numpy")
    want = ref.run_batch(rates, backend="numpy")
    assert len(got) == len(rates)
    assert all(_same(a, b) for a, b in zip(got, want))


def test_batch_equals_solo_runs():
    fast = fast_sim_from_design(make_design("mesh", 16),
                                make_traffic("random_uniform", 16),
                                SimConfig(**_BATCH_CFG))
    rates = [0.05, 0.15, 0.3]
    solo = [fast.run_batch([r], backend="numpy")[0] for r in rates]
    assert solo == fast.run_batch(rates, backend="numpy")


# ---------------------------------------------------------------------------
# the torch backend equals the numpy backend (device="cpu" here; the card
# runs the same loop captured in CUDA graphs, chip_smoke.py phase 18)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern,psize,rates", [
    ("random_uniform", 2, [0.3]),
    ("random_uniform", 2, [0.05, 0.15, 0.3, 0.6, 0.9]),
    ("hotspot", 4, [0.9]),
])
def test_torch_backend_bit_identical_to_numpy(pattern, psize, rates):
    cfg = SimConfig(**dict(_BATCH_CFG, packet_size_flits=psize))
    fast = fast_sim_from_design(make_design("mesh", 16),
                                make_traffic(pattern, 16, seed=0), cfg)
    want = fast.run_batch(rates, cfg, backend="numpy")
    got = fast.run_batch(rates, cfg, backend="torch", device="cpu")
    assert got == want
    assert any(s.packets_measured for s in got)


def _ring(n=6):
    """A unidirectional ring routed one way round: with one VC of two
    flits, 4-flit packets close a cyclic channel dependency and deadlock
    under load."""
    nh = np.array([[u if u == d else (u + 1) % n for d in range(n)]
                   for u in range(n)])
    hop = np.full((n, n), np.inf)
    for u in range(n):
        hop[u, (u + 1) % n] = 1.0
    tp = np.ones((n, n))
    np.fill_diagonal(tp, 0.0)
    cfg = SimConfig(packet_size_flits=4, num_vcs=1, buf_flits_per_vc=2,
                    warmup_cycles=50, measure_cycles=300, drain_cycles=400,
                    deadlock_cycles=60, seed=0)
    return FastSim(nh, hop, np.ones(n), tp, cfg), cfg


def test_torch_backend_deadlock_purge_equals_numpy():
    ring, cfg = _ring()
    rates = [0.05, 0.3, 0.9]
    want = ring.run_batch(rates, cfg, backend="numpy")
    assert [s.deadlock for s in want] == [False, True, True]
    assert ring.run_batch(rates, cfg, backend="torch", device="cpu") == want
    assert [ring.run_batch([r], cfg, backend="torch", device="cpu")[0]
            for r in rates] == want


@pytest.mark.parametrize("backend", ["numpy", "c", "torch"])
def test_watchdog_idle_but_undrained(backend):
    if backend == "c":
        from repro_torch.sim._ckernel import get_kernel
        if get_kernel() is None:
            pytest.skip("no C compiler (cc) on PATH")
    hop = np.full((2, 2), np.inf)
    hop[0, 1] = hop[1, 0] = 5000.0
    tp = np.zeros((2, 2))
    tp[0, 1] = 1.0
    for dc, drain, expect in ((50, 200, True),      # window elapses -> trip
                              (50, 30, False),      # horizon ends first
                              (6000, 20000, False)):  # flit arrives in time
        cfg = SimConfig(packet_size_flits=1, warmup_cycles=0,
                        measure_cycles=10, drain_cycles=drain,
                        deadlock_cycles=dc, seed=0)
        fs = FastSim(next_hop=np.array([[0, 1], [0, 1]]), hop_delay=hop,
                     node_delay=np.zeros(2), traffic_probs=tp, config=cfg)
        st = fs.run_batch([1.0], cfg, backend=backend, device="cpu")[0]
        assert st.deadlock == expect, (backend, dc, drain)
        assert st == fs.run_batch([1.0], cfg, backend="numpy")[0]


def test_torch_backend_guards():
    assert [simfast_torch._pow2_bucket(k) for k in (0, 1, 1024, 1025, 5000)] \
        == [ref_simfast_jax._pow2_bucket(k) for k in (0, 1, 1024, 1025, 5000)]
    fast = fast_sim_from_design(make_design("mesh", 9),
                                make_traffic("random_uniform", 9),
                                SimConfig(**_BATCH_CFG))
    assert fast.run_batch([], backend="torch", device="cpu") == []
    with pytest.raises(ValueError, match="unknown backend"):
        fast.run_batch([0.1], backend="jax")
    with pytest.raises(ValueError, match="workers > 1"):
        saturation_throughput_batched(fast, backend="torch", workers=2,
                                      device="cpu")


# ---------------------------------------------------------------------------
# saturation search
# ---------------------------------------------------------------------------

@pytest.mark.filterwarnings("ignore:os.fork")
def test_batched_search_equals_sequential_and_reference():
    cfg = SimConfig(**_BATCH_CFG)
    fast = fast_sim_from_design(make_design("mesh", 16),
                                make_traffic("random_uniform", 16), cfg)
    seq = saturation_throughput(fast, cfg)
    bat = saturation_throughput_batched(fast, cfg, backend="numpy")
    par = saturation_throughput_batched(fast, cfg, backend="numpy",
                                        workers=2, chunk=6)
    assert (seq.rate, seq.probes) == (bat.rate, bat.probes)
    assert (seq.rate, seq.probes) == (par.rate, par.probes)
    assert seq.zero_load_runs == 1
    assert seq.total_sims == seq.probes + 1
    ref_fast = ref_sim.fast_sim_from_design(
        ref_make_design("mesh", 16), ref_make_traffic("random_uniform", 16),
        ref_sim.SimConfig(**_BATCH_CFG))
    ref = ref_sim.saturation_throughput_batched(ref_fast, backend="numpy")
    assert tuple(bat) == tuple(ref)


def test_torch_saturation_search_equals_numpy():
    """The batched search on the torch backend (device="cpu") visits the
    same rungs and returns the numpy backend's rate and probe count."""
    cfg = SimConfig(**_BATCH_CFG)
    fast = fast_sim_from_design(make_design("mesh", 9),
                                make_traffic("random_uniform", 9), cfg)
    want = saturation_throughput_batched(fast, cfg, backend="numpy")
    got = saturation_throughput_batched(fast, cfg, backend="torch",
                                        device="cpu")
    assert got == want


def test_saturation_ordering_mesh_fb():
    """More bisection bandwidth -> higher saturation point (the port's
    rates equal the reference's)."""
    sat = {}
    for topo in ("mesh", "flattened_butterfly"):
        port, ref = _both(topo, 16, "random_uniform", _BATCH_CFG, "fast")
        sat[topo] = saturation_throughput_batched(port, backend="numpy").rate
        assert sat[topo] == ref_sim.saturation_throughput_batched(
            ref, backend="numpy").rate
    assert sat["flattened_butterfly"] > sat["mesh"]


def test_saturation_search_schedule_counts():
    """The 10% -> 1% -> 0.1% schedule and the paper's probe count (9),
    with the zero-load calibration run counted apart."""
    calls = []

    class FakeSim:
        cfg = SimConfig()

        def run(self, rate, cfg=None):
            calls.append(round(rate, 4))
            stable = rate <= 0.123
            return sim.SimStats(avg_packet_latency=10.0 if stable else 1e9,
                                avg_head_latency=10.0,
                                offered_flits_per_node=rate,
                                accepted_flits_per_node=(rate if stable
                                                         else 0.0),
                                packets_measured=100, stable=stable)

    res = saturation_throughput(FakeSim())
    assert res.rate == pytest.approx(0.123)
    assert (res.probes, res.zero_load_runs, res.total_sims) == (9, 1, 10)
    assert calls == [0.005, 0.1, 0.2, 0.11, 0.12, 0.13,
                     pytest.approx(0.121), pytest.approx(0.122),
                     pytest.approx(0.123), pytest.approx(0.124)]


def test_saturation_result_accounting():
    r = SaturationResult(rate=0.123, probes=9, zero_load_runs=1)
    assert r.total_sims == 10
    rate, probes, zl = r
    assert (rate, probes, zl) == (0.123, 9, 1)


# ---------------------------------------------------------------------------
# the C backend
# ---------------------------------------------------------------------------

def test_c_backend_bit_identical_to_numpy_and_reference():
    from repro_torch.sim._ckernel import get_kernel
    if get_kernel() is None:
        pytest.skip("no C compiler (cc) on PATH")
    for pattern, psize, seed in (("random_uniform", 4, 0),
                                 ("hotspot", 2, 1)):
        kw = dict(packet_size_flits=psize, warmup_cycles=200,
                  measure_cycles=700, drain_cycles=1200, seed=seed)
        port, ref = _both("mesh", 16, pattern, kw, "fast", traffic_seed=0)
        a = port.run_batch([0.04, 0.3, 0.8], backend="numpy")
        b = port.run_batch([0.04, 0.3, 0.8], backend="c")
        assert a == b
        want = ref.run_batch([0.04, 0.3, 0.8], backend="c")
        assert all(_same(x, y) for x, y in zip(b, want))


def test_make_sim_engines():
    design, traffic = make_design("mesh", 9), make_traffic("random_uniform",
                                                           9)
    assert type(make_sim(design, traffic)) is FastSim
    assert type(make_sim(design, traffic, engine="cycle")) is CycleSim
    with pytest.raises(ValueError, match="unknown sim engine"):
        make_sim(design, traffic, engine="booksim")
    assert sorted(sim.ENGINES) == sorted(ref_sim.ENGINES)
    assert sorted(sim.__all__) == sorted(ref_sim.__all__)
