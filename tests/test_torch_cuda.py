"""The port's CUDA kernels on the card: load propagation, min-plus, and
the fused and tiled APSP, each against its plain version, alone vs in a
batch, and the wrappers' refusals; the routing tables and the genome cost
function on the card against the CPU. Every test here needs an NVIDIA
Hopper GPU and skips without one; run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of ``repro``: the machine with the card has no
JAX. Tolerances: W and flow within rtol 1e-5 / atol 1e-6 of the plain
version (the kernel sums each entry in ascending source order, the plain
version's einsum in its own order); min-plus and APSP bit-equal (one add
per candidate, min exact in any order); tables exactly equal; genome
metrics within rtol 1e-5 of the CPU run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_tables(rng, batch: int, n: int, n_real: int | None = None):
    """Random next-hop tables with self-loop (unreachable) pairs, and
    padded vertices above ``n_real`` that route to themselves; dest-major
    load with zero padding."""
    n_real = n if n_real is None else n_real
    nh = rng.integers(0, n_real, size=(batch, n, n)).astype(np.int32)
    ids = np.arange(n, dtype=np.int32)
    stuck = rng.random((batch, n, n)) < 0.05
    nh = np.where(stuck, ids[None, :, None], nh)
    nh[:, ids, ids] = ids
    nh[:, n_real:, :] = ids[n_real:, None]
    nh[:, :, n_real:] = ids[None, :, None]
    l0 = rng.random((batch, n, n)).astype(np.float32)
    l0[:, n_real:, :] = 0.0
    l0[:, :, n_real:] = 0.0
    l0[:, ids, ids] = 0.0
    return nh, l0


@pytest.mark.parametrize("n,batch", [(16, 7), (100, 3), (160, 2), (256, 1)])
def test_kernel_matches_plain(cuda, n, batch):
    from repro_torch.kernels.load_prop import load_prop_cuda, load_prop_plain

    rng = np.random.default_rng(n)
    nh, l0 = random_tables(rng, batch, n, n_real=n - n // 8)
    nh_t = torch.from_numpy(nh).to(cuda)
    l0_t = torch.from_numpy(l0).to(cuda)
    max_hops = 12
    w_k, f_k = load_prop_cuda(nh_t, l0_t, max_hops)
    w_p, f_p = load_prop_plain(nh_t, l0_t, max_hops, adaptive=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(w_k, w_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(f_k, f_p, rtol=RTOL, atol=ATOL)


def test_alone_equals_in_batch(cuda):
    from repro_torch.kernels.load_prop import load_prop_cuda

    rng = np.random.default_rng(0)
    nh, l0 = random_tables(rng, 64, 36)
    nh_t = torch.from_numpy(nh).to(cuda)
    l0_t = torch.from_numpy(l0).to(cuda)
    w_all, f_all = load_prop_cuda(nh_t, l0_t, 20)
    for b in (0, 17, 63):
        w_one, f_one = load_prop_cuda(nh_t[b:b + 1].contiguous(),
                                      l0_t[b:b + 1].contiguous(), 20)
        assert torch.equal(w_one[0], w_all[b])
        assert torch.equal(f_one[0], f_all[b])


def test_ops_routes_cuda_tensors_to_the_kernel(cuda):
    from repro_torch.kernels import load_prop
    from repro_torch.kernels.ops import load_propagate

    rng = np.random.default_rng(1)
    nh, l0 = random_tables(rng, 2, 24)
    before = load_prop.load_prop_cuda.launches
    load_propagate(torch.from_numpy(nh).to(cuda),
                   torch.from_numpy(l0).to(cuda))
    assert load_prop.load_prop_cuda.launches == before + 1


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.load_prop import load_prop_cuda

    nh = torch.zeros((1, 8, 8), dtype=torch.int64, device=cuda)
    l0 = torch.zeros((1, 8, 8), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):
        load_prop_cuda(nh, l0, 4)
    with pytest.raises(ValueError):
        load_prop_cuda(nh.int().transpose(1, 2), l0, 4)
    with pytest.raises(ValueError):
        load_prop_cuda(nh.int().cpu(), l0, 4)


def test_engine_on_cuda_matches_cpu(cuda):
    from repro_torch.dse import DseEngine, ExperimentSpec, expand_experiments

    points = expand_experiments(ExperimentSpec(
        topologies=("mesh", "kite"), chiplet_counts=(16,),
        traffic_patterns=("random_uniform", "hotspot"),
        routings=("dijkstra_lowest_id", "updown_random")))
    gpu = DseEngine(chunk_size=4, device="cuda").run(points)
    cpu = DseEngine(chunk_size=4, device="cpu").run(points)
    np.testing.assert_allclose(gpu.latency, cpu.latency, rtol=RTOL)
    np.testing.assert_allclose(gpu.throughput, cpu.throughput, rtol=RTOL)


def test_engine_design_alone_equals_it_in_a_batch(cuda):
    """The whole device stage (path doubling, reductions, kernel) gives a
    design the same bits alone as in a batch of 64 at the same n."""
    from repro_torch.dse import (DseEngine, ExperimentSpec, encode_designs,
                                 expand_experiments)

    points = expand_experiments(ExperimentSpec(
        topologies=("mesh", "torus", "hexamesh", "kite"),
        chiplet_counts=(16, 36), seeds=(0, 1, 2, 3),
        traffic_patterns=("random_uniform", "hotspot"),
        routings=("dijkstra_lowest_id", "updown_random")))
    engine = DseEngine(device="cuda")
    n = encode_designs(points, validate=False, device=cuda).n
    together = engine.evaluate_points(points, n_pad=n)
    for i in (0, 9, len(points) - 1):
        alone = engine.evaluate_points([points[i]], n_pad=n)
        assert alone.latency[0] == together.latency[i]
        assert alone.throughput[0] == together.throughput[i]


def _minplus_operands(rng, B, M, K, N):
    from repro_torch.kernels.ref import BIG

    a = rng.uniform(0.0, 50.0, (B, M, K)).astype(np.float32)
    b = rng.uniform(0.0, 50.0, (B, K, N)).astype(np.float32)
    a[rng.random(a.shape) < 0.2] = BIG
    b[rng.random(b.shape) < 0.2] = np.inf
    return a, b


@pytest.mark.parametrize("B,M,K,N", [(1, 1, 1, 1), (7, 37, 128, 200),
                                     (3, 200, 37, 1), (2, 128, 200, 128)])
def test_minplus_kernel_bit_equal_to_plain(cuda, B, M, K, N):
    from repro_torch.kernels.minplus import minplus_cuda, minplus_plain

    a, b = _minplus_operands(np.random.default_rng(M + K + N), B, M, K, N)
    a_t, b_t = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got = minplus_cuda(a_t, b_t)
    torch.cuda.synchronize()
    assert torch.equal(got, minplus_plain(a_t, b_t))


def _apsp_input(rng, batch, n):
    from repro_torch.kernels.ref import BIG

    adj = rng.random((batch, n, n)) < 4.0 / n
    d = np.where(adj | adj.transpose(0, 2, 1), 1.0, BIG).astype(np.float32)
    d[:, np.arange(n), np.arange(n)] = 0.0
    return d


@pytest.mark.parametrize("n", [16, 64, 160, 170])
def test_apsp_fused_kernel_bit_equal_to_plain(cuda, n):
    from repro_torch.kernels.apsp import apsp_fused_cuda, apsp_plain

    d = torch.from_numpy(_apsp_input(np.random.default_rng(n), 5, n)).to(cuda)
    got = apsp_fused_cuda(d, 6)
    torch.cuda.synchronize()
    assert torch.equal(got, apsp_plain(d, 6))
    alone = apsp_fused_cuda(d[3:4].contiguous(), 6)
    assert torch.equal(alone[0], got[3])


@pytest.mark.parametrize("n", [161, 200, 256])
def test_apsp_square_kernel_bit_equal_to_plain(cuda, n):
    from repro_torch.kernels.apsp import apsp_plain_blocked, apsp_square_cuda

    d = torch.from_numpy(_apsp_input(np.random.default_rng(n), 3, n)).to(cuda)
    got = apsp_square_cuda(d, 9)
    torch.cuda.synchronize()
    assert torch.equal(got, apsp_plain_blocked(d, 9, 32))
    assert torch.equal(apsp_square_cuda(d[1:2].contiguous(), 9)[0], got[1])


def test_ops_route_cuda_tensors_to_the_min_plus_kernels(cuda):
    from repro_torch.kernels import apsp, minplus
    from repro_torch.kernels.ops import apsp as ops_apsp
    from repro_torch.kernels.ops import minplus_matmul

    d = torch.from_numpy(_apsp_input(np.random.default_rng(0), 2, 40))
    before = (minplus.minplus_cuda.launches, apsp.apsp_fused_cuda.launches,
              apsp.apsp_square_cuda.launches)
    minplus_matmul(d.to(cuda), d.to(cuda))
    got = ops_apsp(d.to(cuda))
    assert torch.equal(got.cpu(), ops_apsp(d))
    big = torch.from_numpy(_apsp_input(np.random.default_rng(1), 1, 180))
    assert torch.equal(ops_apsp(big.to(cuda)).cpu(), ops_apsp(big))
    after = (minplus.minplus_cuda.launches, apsp.apsp_fused_cuda.launches,
             apsp.apsp_square_cuda.launches)
    assert after[0] == before[0] + 1
    assert after[1] == before[1] + 1
    assert after[2] > before[2]


def test_min_plus_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.apsp import MAX_FUSED_N, apsp_fused_cuda
    from repro_torch.kernels.minplus import minplus_cuda

    a = torch.zeros((1, 4, 4), device=cuda)
    with pytest.raises(TypeError):
        minplus_cuda(a.double(), a)
    with pytest.raises(ValueError):
        minplus_cuda(a.transpose(1, 2), a)
    with pytest.raises(ValueError):
        minplus_cuda(a, torch.zeros((1, 5, 4), device=cuda))
    n = MAX_FUSED_N + 1
    with pytest.raises(ValueError):
        apsp_fused_cuda(torch.zeros((1, n, n), device=cuda), 1)


def test_argmax_first_index_rule_on_cuda(cuda):
    from repro_torch.routing.device import _first_true

    mask = torch.zeros((3, 5000), dtype=torch.bool, device=cuda)
    mask[0, [7, 8, 4000]] = True
    mask[1, [4999]] = True
    mask[2, 1000:] = True
    assert _first_true(mask, 1).tolist() == [7, 4999, 1000]


def test_routing_tables_on_cuda_equal_host_tables(cuda):
    from repro_torch.core.graph import build_graph
    from repro_torch.routing.device import (hops_next_hop_batch,
                                            next_hop_lowest_id_batch,
                                            updown_random_table_via_device)
    from repro_torch.routing.tables import (_edge_costs, build_routing_table,
                                            updown_random_table)
    from repro_torch.topologies import make_design

    for n in (36, 256):
        graphs = [build_graph(make_design(t, n))
                  for t in ("mesh", "torus", "hexamesh")]
        cost = np.stack([_edge_costs(g, "hops") for g in graphs])
        want = np.stack([build_routing_table(g) for g in graphs])
        np.testing.assert_array_equal(
            next_hop_lowest_id_batch(cost, device=cuda), want)
        adj = torch.from_numpy(np.isfinite(cost)).to(cuda)
        np.testing.assert_array_equal(hops_next_hop_batch(adj).cpu().numpy(),
                                      want)
    g = build_graph(make_design("kite", 16))
    np.testing.assert_array_equal(
        updown_random_table_via_device(g, seed=3, device=cuda),
        updown_random_table(g, seed=3))


@pytest.mark.parametrize("kind", ["adjacency", "parametric"])
def test_genome_cost_function_on_cuda_matches_cpu(cuda, kind):
    from repro_torch.dse import DseEngine
    from repro_torch.opt import AdjacencySpace, ParametricSpace

    if kind == "adjacency":
        space = AdjacencySpace(n_chiplets=32, max_degree=8)
    else:
        space = ParametricSpace(chiplet_counts=(16, 36))
    pop = space.sample(np.random.default_rng(0), 24)
    gpu = DseEngine(device="cuda").evaluate_genomes(space, pop)
    cpu = DseEngine(device="cpu").evaluate_genomes(space, pop)
    np.testing.assert_allclose(gpu.latency, cpu.latency, rtol=RTOL)
    np.testing.assert_allclose(gpu.throughput, cpu.throughput, rtol=RTOL)
    for f in ("total_chiplet_area", "interposer_area", "power", "cost",
              "reachable_fraction"):
        np.testing.assert_array_equal(getattr(gpu.reports, f),
                                      getattr(cpu.reports, f))
    for i in (0, 23):
        alone = DseEngine(device="cuda").evaluate_genomes(space, pop[i:i + 1])
        assert alone.latency[0] == gpu.latency[i]
        assert alone.throughput[0] == gpu.throughput[i]
