"""The port's CUDA kernels on the card: load propagation, min-plus, the
fused and tiled APSP, flow accumulation and the selective scan, each
against its plain version, alone vs in a batch, and the wrappers' refusals;
the routing tables, the genome cost function and its fault grid, the
optimizers' async and sync drivers, the pair-walk throughput,
a reduced Falcon-Mamba training step on the card against the CPU, its
resume from a checkpoint (bit-equal to the uninterrupted run), every
analysis contract recorded on the card, a trace through
``evaluate_design`` against the f64 oracle (rtol 1e-5),
``latency_vs_load``'s torch rows (equal to numpy's), and serving every
decoder-only config at reduced widths against the CPU (greedy tokens equal,
logits within 1e-5) with the hybrid's prefill on the scan kernel, the pod
interconnect model's estimates against the CPU (rtol 1e-5), compression
over an NCCL world of one, the dry-run's meta-trace FLOPs against a
train step on the card (exactly equal), and the population sharded over
``["cuda:0"] * k`` bit-equal to one shard. Every test here needs an NVIDIA
Hopper GPU and skips without one; run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of ``repro``: the machine with the card has no
JAX. Tolerances: W and flow within rtol 1e-5 / atol 1e-6 of the plain
version (the kernel sums each entry in ascending source order, the plain
version's einsum in its own order); min-plus and APSP bit-equal (one add
per candidate, min exact in any order); tables exactly equal; genome
metrics within rtol 1e-5 of the CPU run; flow accumulation bit-equal to the
CPU's ascending-p scatter; the selective scan within rtol 1e-4 / atol 1e-5
(forward) and rtol 2e-3 / atol 5e-4 (backward) of its plain version, the
reference's own bounds (exps and sums over N and channels in another
order), and bit-equal between two runs and alone vs in a batch; the scan
forward's checkpoints and final states bit-equal to its first design's
(``tools/scan_fwd_steps.py``, built with nvcc by the test); load
propagation and the fused APSP bit-equal to their first designs'
(``tools/load_prop_steps.py``, ``tools/apsp_steps.py``, built the same way).
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


def _first_design(tool: str):
    """The first design's library, built with nvcc from ``tools/<tool>.py``."""
    import importlib
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    mod = importlib.import_module(tool)
    return mod, mod.finish_build(mod.start_build("first"))[0]


@pytest.mark.parametrize("n,batch", [(16, 7), (100, 3), (160, 2), (256, 1)])
def test_load_prop_kernel_bit_equal_to_the_first_design(cuda, n, batch):
    """W and flow are bit-equal to the first design's
    (``tools/load_prop_steps.py``): both sum in ascending u and d."""
    from repro_torch.kernels.load_prop import load_prop_cuda

    tool, lib = _first_design("load_prop_steps")
    nh, l0 = random_tables(np.random.default_rng(n + 1), batch, n,
                           n_real=n - n // 8)
    nh_t = torch.from_numpy(nh).to(cuda)
    l0_t = torch.from_numpy(l0).to(cuda)
    for hops in (12, n + 2):
        got = load_prop_cuda(nh_t, l0_t, hops)
        want = tool.run(lib, "first", nh_t, l0_t, hops)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("B,M,K,N", [
    (1, 64, 31, 64), (1, 64, 32, 64), (1, 64, 33, 64), (1, 64, 64, 64),
    (1, 64, 127, 64), (1, 64, 128, 64), (1, 64, 129, 64), (2, 70, 255, 65),
    (3, 63, 100, 64), (5, 7, 100, 20), (1, 31, 64, 33), (4, 1, 300, 1),
    (32, 32, 32, 32), (2, 5, 0, 7), (8, 256, 256, 64), (3, 256, 256, 256)])
def test_minplus_kernel_at_split_and_tile_edges(cuda, B, M, K, N):
    """K below, at and above each point where the k split over a cluster
    doubles, M and N below the 32 x 32 tile, K = 0, the paths' shapes:
    bit-equal to plain, two runs equal, the last design alone equal to it
    in the batch, and operands 4 bytes off 16-byte alignment equal too."""
    from repro_torch.kernels.minplus import minplus_cuda, minplus_plain

    a, b = _minplus_operands(np.random.default_rng(M * K + N), B, M, K, N)
    a_t, b_t = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got = minplus_cuda(a_t, b_t)
    torch.cuda.synchronize()
    assert torch.equal(got, minplus_plain(a_t, b_t))
    assert torch.equal(minplus_cuda(a_t, b_t), got)
    one = minplus_cuda(a_t[B - 1:].contiguous(), b_t[B - 1:].contiguous())
    assert torch.equal(one[0], got[B - 1])
    off = []
    for x in (a_t, b_t):
        buf = torch.empty(x.numel() + 1, device=cuda)
        off.append(buf[1:].view(x.shape))
        off[-1].copy_(x)
    assert torch.equal(minplus_cuda(*off), got)


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


@pytest.mark.parametrize("n", [16, 64, 160, 170])
def test_apsp_fused_kernel_bit_equal_to_the_first_design(cuda, n):
    """The cluster kernel, with its stop at the fixed point, is bit-equal to
    the first design's all n_iters squarings (``tools/apsp_steps.py``), at
    few and at many squarings."""
    from repro_torch.kernels.apsp import apsp_fused_cuda

    tool, lib = _first_design("apsp_steps")
    d = torch.from_numpy(_apsp_input(np.random.default_rng(n + 1), 5, n)
                         ).to(cuda)
    for n_iters in (2, 9):
        got = apsp_fused_cuda(d, n_iters)
        torch.cuda.synchronize()
        assert torch.equal(got, tool.run(lib, d, n_iters))


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


@pytest.mark.parametrize("model", ["iid", "chiplet"])
def test_fault_grid_on_cuda_matches_cpu(cuda, model):
    """The [P, F] grid on the card within rtol 1e-5 of the CPU's, the
    pristine column bit-equal to evaluate_genomes on the card, a genome
    alone bit-equal to it in the grid (dead chiplets: disconnected
    graphs)."""
    from repro_torch.dse import DseEngine
    from repro_torch.faults.model import make_scenarios
    from repro_torch.opt import AdjacencySpace

    space = AdjacencySpace(n_chiplets=32, max_degree=8)
    pop = space.sample(np.random.default_rng(1), 12)
    kw = {"p": 0.05, "n_scenarios": 7, "seed": 0} if model == "iid" else {}
    sc = make_scenarios(space, model, **kw)

    def grid(device, genomes=pop):
        return DseEngine(device=device).evaluate_genomes_faults_async(
            space, genomes, sc.link_fail, sc.node_fail).result()

    gpu, cpu = grid("cuda"), grid("cpu")
    fields = ("latency", "throughput", "reachable_fraction")
    for f in fields:
        np.testing.assert_allclose(getattr(gpu, f), getattr(cpu, f),
                                   rtol=RTOL, atol=0.0)
    plain = DseEngine(device="cuda").evaluate_genomes(space, pop)
    np.testing.assert_array_equal(gpu.latency[:, 0], plain.latency)
    np.testing.assert_array_equal(gpu.throughput[:, 0], plain.throughput)
    alone = grid("cuda", pop[5:6])
    for f in fields:
        np.testing.assert_array_equal(getattr(alone, f)[0],
                                      getattr(gpu, f)[5])


@pytest.mark.parametrize("algo", ["nsga2", "sa", "random"])
def test_optimizer_async_equals_sync_on_cuda(cuda, algo):
    from repro_torch.opt import (ALGORITHMS, AdjacencySpace, OptRunner,
                                 PopulationEvaluator)

    size = {"nsga2": "pop_size", "sa": "n_chains", "random": "batch_size"}
    states = []
    for mode in (False, True):
        space = AdjacencySpace(n_chiplets=16, max_degree=5)
        opt = ALGORITHMS[algo](space, PopulationEvaluator(space),
                               seed=7, **{size[algo]: 12})
        OptRunner(opt, async_pipeline=mode).run(4)
        states.append(opt.state())
    assert states[0] == states[1]


def _scan_inputs(rng, B, S, Di, N, dev):
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    return (f(rng.normal(0, 1, (B, S, Di))),
            f(rng.uniform(0.01, 0.2, (B, S, Di))),
            f(rng.normal(0, 1, (B, S, N))), f(rng.normal(0, 1, (B, S, N))),
            f(-rng.uniform(0.5, 2.0, (Di, N))),
            f(rng.normal(0, 0.3, (B, Di, N))),
            f(rng.normal(0, 1, (B, S, Di))))


@pytest.mark.parametrize("B,S,Di,N,chunk", [(2, 24, 12, 4, 8),
                                            (2, 24, 12, 8, 8),
                                            (3, 96, 100, 16, 32),
                                            (1, 512, 256, 16, 256),
                                            (2, 96, 40, 4, 24),
                                            (2, 96, 72, 8, 48),
                                            (3, 120, 100, 16, 40),
                                            (2, 200, 37, 5, 200),
                                            (1, 1024, 70, 16, 512),
                                            (2, 64, 37, 1, 16),
                                            (2, 80, 50, 3, 40),
                                            (3, 72, 70, 12, 24)])
def test_selective_scan_kernels_match_plain(cuda, B, S, Di, N, chunk):
    from repro_torch.kernels import selective_scan as ss

    xc, dt, bm, cm, a, h0, dy = _scan_inputs(np.random.default_rng(S + N),
                                             B, S, Di, N, cuda)
    got = ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0, chunk=chunk)
    want = ss.selective_scan_fwd_plain(xc, dt, bm, cm, a, h0, chunk=chunk)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=1e-4, atol=1e-5)
    ckpt = got[1]
    again = ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0, chunk=chunk)
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    grads = ss.selective_scan_bwd_cuda(xc, dt, bm, cm, a, ckpt, dy,
                                       chunk=chunk)
    want = ss.selective_scan_bwd_plain(xc, dt, bm, cm, a, ckpt, dy,
                                       chunk=chunk)
    for g, w in zip(grads, want):
        assert torch.allclose(g, w, rtol=2e-3, atol=5e-4)
    again = ss.selective_scan_bwd_cuda(xc, dt, bm, cm, a, ckpt, dy,
                                       chunk=chunk)
    assert all(torch.equal(g, h) for g, h in zip(grads, again))
    b = B - 1
    one = [t[b:b + 1].contiguous() for t in (xc, dt, bm, cm)]
    y1, c1, h1 = ss.selective_scan_fwd_cuda(*one, a, h0[b:b + 1].contiguous(),
                                            chunk=chunk)
    assert torch.equal(y1[0], got[0][b]) and torch.equal(c1[0], ckpt[b])
    g1 = ss.selective_scan_bwd_cuda(*one, a, c1, dy[b:b + 1].contiguous(),
                                    chunk=chunk)
    for i in (0, 1, 2, 3, 5):          # da sums over the batch
        assert torch.equal(g1[i][0], grads[i][b])


@pytest.mark.parametrize("B,S,Di,N,chunk", [(2, 96, 40, 4, 24),
                                            (2, 64, 37, 1, 16),
                                            (3, 72, 70, 12, 24),
                                            (1, 512, 256, 16, 256)])
def test_selective_scan_forward_states_equal_the_first_design(cuda, B, S, Di,
                                                              N, chunk):
    """The forward's checkpoints and final states are bit-equal to its first
    design's (one thread per channel, ``tools/scan_fwd_steps.py``), which
    the backward's recomputation from those checkpoints was held against:
    the backward still matches its plain version on them."""
    import os
    import sys

    from repro_torch.kernels import selective_scan as ss

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import scan_fwd_steps as sfs

    lib, _ = sfs.finish_build(sfs.start_build("one_thread"))
    xc, dt, bm, cm, a, h0, dy = _scan_inputs(np.random.default_rng(S * N),
                                             B, S, Di, N, cuda)
    y, ckpt, ht = ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0,
                                             chunk=chunk)
    y0, ckpt0, ht0 = sfs.forward(lib, xc, dt, bm, cm, a, h0, chunk)
    torch.cuda.synchronize()
    assert torch.equal(ckpt, ckpt0) and torch.equal(ht, ht0)
    assert torch.allclose(y, y0, rtol=1e-4, atol=1e-5)
    grads = ss.selective_scan_bwd_cuda(xc, dt, bm, cm, a, ckpt, dy,
                                       chunk=chunk)
    want = ss.selective_scan_bwd_plain(xc, dt, bm, cm, a, ckpt0, dy,
                                       chunk=chunk)
    for g, w in zip(grads, want):
        assert torch.allclose(g, w, rtol=2e-3, atol=5e-4)


def test_selective_scan_autograd_on_cuda_launches_both_kernels(cuda):
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as ss

    xc, dt, bm, cm, a, h0, dy = _scan_inputs(np.random.default_rng(0),
                                             2, 64, 40, 16, cuda)
    args = [t.clone().requires_grad_() for t in (xc, dt, bm, cm, a, h0)]
    f0 = ss.selective_scan_fwd_cuda.launches
    b0 = ss.selective_scan_bwd_cuda.launches
    y = ops.selective_scan(*args, 16)
    got = torch.autograd.grad(y, args, dy)
    assert ss.selective_scan_fwd_cuda.launches == f0 + 1
    assert ss.selective_scan_bwd_cuda.launches == b0 + 1
    plain = [t.clone().requires_grad_() for t in (xc, dt, bm, cm, a, h0)]
    y_p, _, _ = ss.selective_scan_fwd_plain(*plain, chunk=16)
    want = torch.autograd.grad(y_p, plain, dy)
    for g, w in zip(got, want):
        assert torch.allclose(g, w, rtol=2e-3, atol=5e-4)
    with pytest.raises(ValueError, match="N <= 16"):
        ss.selective_scan_fwd_cuda(xc[..., :4].contiguous(),
                                   dt[..., :4].contiguous(),
                                   torch.zeros((2, 64, 17), device=cuda),
                                   torch.zeros((2, 64, 17), device=cuda),
                                   torch.zeros((4, 17), device=cuda),
                                   torch.zeros((2, 4, 17), device=cuda),
                                   chunk=16)


def _flow_pairs(rng, B, n, P, kind):
    if kind == "two_rows":              # duplicate cells, two rows
        return (rng.integers(0, 2, (B, P)), rng.integers(0, 2, (B, P)))
    if kind == "one_row":               # one row holds every pair
        return np.full((B, P), n // 2), rng.integers(0, n, (B, P))
    if kind == "out_of_range":          # dropped by the kernel
        return (rng.integers(-3, n + 3, (B, P)),
                rng.integers(-3, n + 3, (B, P)))
    return rng.integers(0, n, (B, P)), rng.integers(0, n, (B, P))


@pytest.mark.parametrize("B,n,P,kind", [
    (1, 8, 64, "uniform"), (4, 20, 400, "uniform"), (13, 64, 4096, "uniform"),
    (1, 256, 65536, "uniform"), (3, 130, 16900, "uniform"),
    (1, 6, 300, "two_rows"), (2, 33, 1000, "one_row"),
    (2, 20, 777, "uniform"), (3, 12, 500, "out_of_range"),
    (5, 64, 4096, "uniform"), (2, 256, 140000, "one_row"),
    (1, 1720, 50000, "uniform")])
def test_flow_accum_kernel_bit_equal_to_cpu_scatter(cuda, B, n, P, kind):
    """Bit-equal to the CPU's ascending-p scatter of the in-range pairs
    (the kernel drops the others), alone == in a batch, two runs equal."""
    from repro_torch.kernels import flow_accum as fa

    rng = np.random.default_rng(n + P)
    cur, nxt = (x.astype(np.int32) for x in _flow_pairs(rng, B, n, P, kind))
    live = (cur >= 0) & (cur < n) & (nxt >= 0) & (nxt < n)
    flow = torch.from_numpy(rng.uniform(0, 5, (B, n, n)).astype(np.float32))
    amt = rng.uniform(0, 2, (B, P)).astype(np.float32)
    kept = [torch.from_numpy(np.where(live, x, 0).astype(x.dtype))
            for x in (cur, nxt, amt)]
    want = fa.flow_accum_plain(flow, *kept)
    args = [t.to(cuda) for t in (flow, torch.from_numpy(cur),
                                 torch.from_numpy(nxt), torch.from_numpy(amt))]
    got = fa.flow_accum_cuda(*args)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(fa.flow_accum_cuda(*args), got)
    if kind != "out_of_range":
        assert torch.allclose(got, fa.flow_accum_plain(*args), rtol=1e-5,
                              atol=1e-5)
    one = fa.flow_accum_cuda(*(t[B - 1:B].contiguous() for t in args))
    assert torch.equal(one[0], got[B - 1])


def test_pair_walk_throughput_on_cuda_matches_load_route(cuda):
    from repro_torch.core import prepare_arrays, throughput
    from repro_torch.core.latency import routed_diameter
    from repro_torch.kernels import flow_accum as fa
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic

    arrays, _ = prepare_arrays(make_design("hexamesh", 36))
    nh = torch.from_numpy(arrays.next_hop).to(cuda)
    bw = torch.from_numpy(arrays.adj_bw).to(cuda)
    t = torch.from_numpy(make_traffic("hotspot", 36).astype(np.float32)
                         ).to(cuda)
    mh = routed_diameter(torch.from_numpy(arrays.next_hop))
    launches = fa.flow_accum_cuda.launches
    walk = throughput.throughput_proxy(nh, bw, t, mh, True)
    assert fa.flow_accum_cuda.launches == launches + mh
    load = throughput.throughput_proxy(nh, bw, t, mh, False)
    assert torch.allclose(walk, load, rtol=RTOL, atol=0.0)
    cpu = throughput.throughput_proxy(nh.cpu(), bw.cpu(), t.cpu(), mh, True)
    assert torch.allclose(walk.cpu(), cpu, rtol=1e-6, atol=0.0)


def test_reduced_falcon_mamba_step_on_cuda_matches_cpu(cuda):
    """One AdamW step of the reduced model in float32 on the kernel route:
    loss and grad norm within rtol 1e-4 of the CPU (plain route), both scan
    kernels launched (the forward twice: remat recomputes it)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.train import build_state, to_device
    from repro_torch.models import Model, reduced
    from repro_torch.train import OptConfig, make_train_step

    cfg = reduced(get_config("falcon-mamba-7b"), ssm_chunk=8,
                  dtype="float32", ssm_kernel=True)
    batch = SyntheticTokens(cfg.vocab_size, 2, 32, seed=1).batch_at(0)
    ocfg = OptConfig(learning_rate=1e-3, warmup_steps=0, decay_steps=10)
    out = {}
    f0 = ss.selective_scan_fwd_cuda.launches
    b0 = ss.selective_scan_bwd_cuda.launches
    for dev in ("cpu", cuda):
        model = Model(cfg, seed=0, device=dev)
        step = make_train_step(model, ocfg)
        _, m = step(build_state(model, "adamw"), to_device(batch, dev))
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]))
    assert ss.selective_scan_fwd_cuda.launches - f0 == 2 * cfg.n_layers
    assert ss.selective_scan_bwd_cuda.launches - b0 == cfg.n_layers
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert lg == pytest.approx(lc, rel=1e-4)
    assert gg == pytest.approx(gc, rel=1e-4)


def test_model_seed_gives_the_same_weights_on_every_device(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import Model, reduced

    cfg = reduced(get_config("falcon-mamba-7b"))
    on_cpu = Model(cfg, seed=5, device="cpu").state_dict()
    on_card = Model(cfg, seed=5, device=cuda).state_dict()
    assert on_cpu.keys() == on_card.keys()
    for k, v in on_card.items():
        assert v.device.type == "cuda"
        assert torch.equal(v.cpu(), on_cpu[k]), k


def test_resumed_training_on_cuda_equals_uninterrupted(cuda, tmp_path,
                                                       monkeypatch):
    """4 steps on the card == 2 steps, a SIGTERM checkpoint and a resume
    for 2 more: losses, parameters and AdamW moments bit-equal."""
    import signal

    import repro_torch.launch.train as T
    from repro_torch.configs import get_config
    from repro_torch.models import reduced

    cfg = reduced(get_config("falcon-mamba-7b"), ssm_kernel=True)
    kw = dict(steps=4, batch=2, seq_len=64, lr=5e-3, log_every=100,
              device=cuda)
    full, full_losses = T.train(cfg, **kw)
    real = T.make_train_step

    def preempted(*args, **k):
        fn = real(*args, **k)
        calls = {"n": 0}

        def step(state, batch):
            out = fn(state, batch)
            calls["n"] += 1
            if calls["n"] == 2:
                signal.raise_signal(signal.SIGTERM)
            return out
        return step

    d = str(tmp_path / "ck")
    monkeypatch.setattr(T, "make_train_step", preempted)
    _, first = T.train(cfg, ckpt_dir=d, **kw)
    monkeypatch.setattr(T, "make_train_step", real)
    state, rest = T.train(cfg, ckpt_dir=d, **kw)
    assert first + rest == full_losses
    assert state["step"] == full["step"] == 4
    for k in full["params"]:
        assert state["params"][k].device.type == "cuda"
        assert torch.equal(state["params"][k], full["params"][k]), k
    for m in full["opt"]:
        for k in full["opt"][m]:
            assert torch.equal(state["opt"][m][k], full["opt"][m][k]), (m, k)


def _contract_names():
    from repro_torch.analysis.registry import contracts

    return [c.name for c in contracts()]


@pytest.mark.parametrize("name", _contract_names())
def test_analysis_contract_passes_on_cuda(cuda, name):
    """Each registry contract recorded on the card: no finding, the
    kernels it names launched (the audit's kernel-route check), and every
    run's outputs equal the CPU's plain forms within the contract's parity
    (the audit's cpu-parity check)."""
    import repro_torch.core  # noqa: F401  (import order)
    from repro_torch.analysis.graph_audit import audit_contract
    from repro_torch.analysis.registry import contracts

    c = next(c for c in contracts() if c.name == name)
    info: dict = {}
    assert [f.format() for f in audit_contract(c, cuda, info)] == []
    assert (c.parity is None) == ("cpu_max_abs_err" not in info)
    assert c.parity is not None or not c.kernels


def test_trace_through_evaluate_design_on_cuda_matches_the_oracle(cuda):
    import repro_torch.core  # noqa: F401
    from repro_torch.core import evaluate_design
    from repro_torch.core.graph import build_graph
    from repro_torch.core.reference import (latency_reference,
                                            throughput_reference)
    from repro_torch.routing.tables import build_routing_table
    from repro_torch.topologies import make_design
    from repro_torch.traffic import aggregate_trace
    from repro_torch.traffic.trace import synthetic_trace

    design = make_design("torus", 36)
    traffic = aggregate_trace(synthetic_trace(36, 5000, seed=2), 36)
    got = evaluate_design(design, traffic, device=cuda)
    g = build_graph(design)
    nh = build_routing_table(g, design.routing, design.routing_metric,
                             design.seed)
    assert got.latency == pytest.approx(latency_reference(g, nh, traffic),
                                        rel=1e-5)
    assert got.throughput == pytest.approx(
        throughput_reference(g, nh, traffic), rel=1e-5)


def test_latency_vs_load_torch_on_cuda_equals_numpy(cuda):
    from repro_torch.core.visualize import latency_vs_load
    from repro_torch.sim import SimConfig
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic

    cfg = SimConfig(packet_size_flits=1, warmup_cycles=200,
                    measure_cycles=600, drain_cycles=800)
    args = (make_design("mesh", 16), make_traffic("transpose", 16))
    rows = latency_vs_load(*args, rates=(0.02, 0.2, 0.6), config=cfg,
                           backend="torch", device=cuda)
    assert rows == latency_vs_load(*args, rates=(0.02, 0.2, 0.6),
                                   config=cfg, backend="numpy")


_SERVE_ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "olmoe-1b-7b",
                "nemotron-4-15b", "glm4-9b", "codeqwen1.5-7b",
                "falcon-mamba-7b", "llava-next-34b", "hymba-1.5b")


@pytest.mark.parametrize("arch", _SERVE_ARCHS)
def test_serving_on_cuda_matches_cpu(cuda, arch):
    """``launch.serve.generate`` at ``reduced(cfg, dtype="float32")``: the
    greedy tokens on the card equal the CPU's, and every decode step's
    logits (prompt and generated tokens fed back) and a 64-position
    prefill's are within rtol 1e-5 / atol 1e-5; the Mamba configs take the
    scan kernel on the card and its plain version on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model, reduced

    cfg = reduced(get_config(arch), dtype="float32")
    if cfg.uses_ssm:
        cfg = cfg.replace(ssm_kernel=True)
    models = {d: Model(cfg, seed=0, device=d) for d in ("cpu", cuda)}
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 8))
    tokens = {d: generate(m, prompts, 6) for d, m in models.items()}
    np.testing.assert_array_equal(tokens[cuda], tokens["cpu"])
    seq = torch.from_numpy(np.concatenate([prompts, tokens["cpu"]], 1))
    n_img = cfg.n_image_tokens if cfg.family == "vlm" else 0
    rng = np.random.default_rng(2)
    text = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64 - n_img)))
    patches = torch.from_numpy(rng.normal(
        0, 1, (2, n_img, cfg.d_model)).astype(np.float32))
    out = {}
    for d, m in models.items():
        cache = m.init_cache(3, seq.shape[1])
        steps = [m.decode_step(cache, seq[:, t:t + 1].to(d), t)[0]
                 for t in range(seq.shape[1])]
        extra = {"patches": patches.to(d)} if n_img else None
        out[str(d)] = (torch.cat(steps, 1).cpu(),
                       m.prefill(text.to(d), extra=extra).cpu())
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_hybrid_prefill_on_cuda_runs_the_scan_kernel_once_a_layer(cuda):
    """hymba's prefill with ``ssm_kernel=True`` launches B7 once per Mamba
    layer, and its float32 logits are within 1e-4 of the chunked-scan
    route's on the same weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.models import Model, reduced

    cfg = reduced(get_config("hymba-1.5b"), dtype="float32", ssm_kernel=True)
    model = Model(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64))).to(cuda)
    before = ss.selective_scan_fwd_cuda.launches
    kernel = model.prefill(tokens)
    assert ss.selective_scan_fwd_cuda.launches - before == cfg.n_layers
    model.cfg = dataclasses.replace(cfg, ssm_kernel=False)
    chunked = model.prefill(tokens)
    assert ss.selective_scan_fwd_cuda.launches - before == cfg.n_layers
    assert torch.allclose(kernel, chunked, rtol=1e-4, atol=1e-4)


_TRAIN_ARCHS = ("qwen2.5-3b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
                "hymba-1.5b", "llava-next-34b", "whisper-medium")


def _pipeline_batch(cfg, seq: int, seed: int):
    from repro_torch.data import make_pipeline
    return make_pipeline(cfg, 2, seq, seed=seed).batch_at(0)


@pytest.mark.parametrize("arch", _TRAIN_ARCHS)
def test_family_loss_and_grads_on_cuda_match_cpu(cuda, arch):
    """Each trained family at ``reduced(cfg, dtype="float32")``: the loss
    within rtol 1e-5 and every gradient leaf within rtol 1e-3 / atol 1e-5
    of the CPU's (the reference's gradient bounds); hymba through B7 and
    B8, each launched as remat "full" predicts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.train import to_device
    from repro_torch.models import Model, reduced

    cfg = reduced(get_config(arch), dtype="float32")
    if cfg.uses_ssm:
        cfg = cfg.replace(ssm_kernel=True)
    host = _pipeline_batch(cfg, 128 if cfg.uses_ssm else 64, seed=1)
    out = {}
    launches = {}
    for d in ("cpu", cuda):
        f0 = ss.selective_scan_fwd_cuda.launches
        b0 = ss.selective_scan_bwd_cuda.launches
        model = Model(cfg, seed=0, device=d)
        loss, _ = model.loss(to_device(host, torch.device(d)))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[str(d)] = (loss.detach().cpu(), [g.cpu() for g in grads])
        launches[str(d)] = (ss.selective_scan_fwd_cuda.launches - f0,
                            ss.selective_scan_bwd_cuda.launches - b0)
    layers = cfg.n_layers if cfg.uses_ssm else 0
    assert launches[str(cuda)] == (2 * layers, layers)
    assert launches["cpu"] == (0, 0)
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert float(lg) == pytest.approx(float(lc), rel=1e-5)
    for a, b in zip(gg, gc):
        assert torch.allclose(a, b, rtol=1e-3, atol=1e-5)


def test_whisper_on_cuda_matches_cpu(cuda):
    """whisper-medium at ``reduced(cfg, dtype="float32")``: the encoder,
    the forward, the loss, the prefill and 8 decode steps with the cross-KV
    cache filled from the encoder, within rtol 1e-5 / atol 1e-5 of the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, reduced

    cfg = reduced(get_config("whisper-medium"), dtype="float32")
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65)))
    frames = torch.from_numpy(rng.normal(
        0, 1, (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    out = {}
    for d in ("cpu", cuda):
        model = Model(cfg, seed=0, device=d)
        fr = frames.to(d)
        batch = {"tokens": tok[:, :-1].to(d), "labels": tok[:, 1:].to(d),
                 "frames": fr}
        with torch.no_grad():
            enc, _ = model._encode(fr)
            x, _ = model(batch["tokens"], extra={"frames": fr})
            loss, _ = model.loss(batch)
        cache = model.init_cache(2, 8)
        cache["cross_k"], cache["cross_v"] = model.cross_kv(enc)
        steps = [model.decode_step(cache, batch["tokens"][:, t:t + 1], t)[0]
                 for t in range(8)]
        out[str(d)] = [t.cpu() for t in (
            enc, x, loss, model.prefill(batch["tokens"], extra={"frames": fr}),
            torch.cat(steps, 1))]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


def test_remat_dots_on_cuda_equals_full_and_none(cuda):
    """hymba at reduced widths on the card: remat "dots", "full" and "none"
    give bit-equal losses and gradients; "dots" and "full" run B7 twice a
    Mamba layer (the policy never sees the ctypes call, so it is
    recomputed), "none" once; B8 once a layer under each."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.launch.train import to_device
    from repro_torch.models import Model, reduced

    cfg = reduced(get_config("hymba-1.5b"), ssm_kernel=True)
    batch = to_device(_pipeline_batch(cfg, 128, seed=2), cuda)
    out = {}
    for remat in ("dots", "full", "none"):
        f0 = ss.selective_scan_fwd_cuda.launches
        b0 = ss.selective_scan_bwd_cuda.launches
        model = Model(cfg.replace(remat=remat), seed=0, device=cuda)
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[remat] = (loss.detach(), grads)
        passes = 1 if remat == "none" else 2
        assert (ss.selective_scan_fwd_cuda.launches - f0,
                ss.selective_scan_bwd_cuda.launches - b0) == (
            passes * cfg.n_layers, cfg.n_layers)
    for remat in ("full", "none"):
        assert torch.equal(out["dots"][0], out[remat][0])
        for a, b in zip(out["dots"][1], out[remat][1]):
            assert torch.equal(a, b)


def test_make_inputs_on_cuda_equal_the_cpu_ones(cuda):
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import ShapeSpec, make_inputs, reduced

    spec = ShapeSpec("smoke_train", 72, 2, "train")
    for arch in ARCH_IDS:
        cfg = reduced(get_config(arch))
        on_card = make_inputs(cfg, spec, seed=3)
        on_cpu = make_inputs(cfg, spec, seed=3, device="cpu")
        assert on_card.keys() == on_cpu.keys()
        for k, v in on_card.items():
            assert v.device.type == "cuda" and torch.equal(v.cpu(),
                                                           on_cpu[k]), k


@pytest.mark.parametrize("rows", [4, 16])
def test_ici_estimates_on_cuda_match_cpu(cuda, rows):
    """Every collective kind over both axes of the pod, torus and mesh: one
    load-propagation launch per estimate (B1 at 4 x 4, B2 at 16 x 16),
    every field within rtol 1e-5 of the CPU's."""
    import dataclasses

    from repro_torch.core.ici_model import estimate_collective
    from repro_torch.kernels import load_prop as lp

    before = lp.load_prop_cuda.launches
    calls = 0
    for wrap in (True, False):
        for kind in ("all_gather", "reduce_scatter", "all_reduce",
                     "all_to_all"):
            for axis in ("data", "model"):
                got = estimate_collective(kind, axis, 4e9, rows=rows,
                                          cols=rows, wrap=wrap, device=cuda)
                calls += 1
                want = estimate_collective(kind, axis, 4e9, rows=rows,
                                           cols=rows, wrap=wrap,
                                           device="cpu")
                for f in dataclasses.fields(want):
                    g, w = getattr(got, f.name), getattr(want, f.name)
                    if isinstance(w, str):
                        assert g == w
                    else:
                        assert g == pytest.approx(w, rel=1e-5), f.name
    assert lp.load_prop_cuda.launches - before == calls


def test_compression_over_an_nccl_world_of_one(cuda):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import MeshShape
    from repro_torch.sharding.compression import (make_compressed_allreduce,
                                                  quantize_int8)
    from repro_torch.sharding.pipeline import pipeline_apply

    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn((4096, 4096), generator=gen, device=cuda)
    for a, b in zip(quantize_int8(x), quantize_int8(x.cpu())):
        assert torch.equal(a.cpu(), b)
    torch.cuda.set_device(cuda.index or 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        out = make_compressed_allreduce(mesh, axes=("data",))({"x": x})["x"]
        _, scale = quantize_int8(x)
        assert (out - x).abs().max().item() <= 0.5 * scale.max().item() * \
            (1 + 1e-6)
    finally:
        dist.destroy_process_group()
    w = torch.randn((1, 64, 64), generator=gen, device=cuda) * 0.1
    xs = torch.randn((5, 4, 64), generator=gen, device=cuda)
    fn = pipeline_apply(lambda p, v: torch.tanh(v @ p),
                        MeshShape(("stage",), (1,)))
    assert torch.equal(fn(w, xs),
                       torch.stack([torch.tanh(x @ w[0]) for x in xs]))


def test_meta_trace_flops_equal_a_train_step_on_cuda(cuda):
    """The dry-run's meta trace of qwen2.5-3b at published widths cut to 2
    layers counts exactly the FLOPs of the same train step on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import Model, ShapeSpec, make_inputs
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    from repro_torch.train.state import init_train_state

    cfg = D.cut_depth(get_config("qwen2.5-3b"), 2)
    spec = ShapeSpec("flop_check", 2048, 2, "train")
    meta = D.count_step(cfg, spec)
    model = Model(cfg, device="meta").to_empty(device=cuda)
    torch.manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.fill_(1.0) if name.endswith("scale") else p.normal_(0, 0.02)
    step = make_train_step(model, OptConfig())
    with FlopCounterMode(display=False) as fc:
        _, metrics = step(init_train_state(model, adamw_init),
                          make_inputs(cfg, spec, device=cuda))
    assert fc.get_total_flops() == meta["flops"] > 0
    assert torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind", ["adjacency", "parametric", "faults",
                                  "points"])
def test_shards_of_one_card_equal_one_shard(cuda, k, kind):
    """Population sharding over ``["cuda:0"] * k``: every path bit-equal
    to one shard on the card (each shard its own dispatch, adaptive loops
    and kernel launches; 1-row shards at population 4 and k = 4)."""
    from repro_torch.dse import (DseEngine, ExperimentSpec,
                                 expand_experiments)
    from repro_torch.faults.model import make_scenarios
    from repro_torch.opt import AdjacencySpace, ParametricSpace

    dev = torch.device("cuda", 0)
    one, many = DseEngine(devices=[dev]), DseEngine(devices=[dev] * k)
    if kind == "points":
        pts = expand_experiments(ExperimentSpec(
            topologies=("mesh", "kite"), chiplet_counts=(16, 36)))[:7]
        got, want = many.evaluate_points(pts), one.evaluate_points(pts)
        fields = ("latency", "throughput")
    elif kind == "faults":
        space = AdjacencySpace(n_chiplets=32, max_degree=8)
        pop = space.sample(np.random.default_rng(2), 4)
        sc = make_scenarios(space, "chiplet")
        got, want = (e.evaluate_genomes_faults_async(
            space, pop, sc.link_fail, sc.node_fail).result()
            for e in (many, one))
        fields = ("latency", "throughput", "reachable_fraction")
    else:
        space = (AdjacencySpace(n_chiplets=32, max_degree=8)
                 if kind == "adjacency"
                 else ParametricSpace(chiplet_counts=(16, 36)))
        pop = space.sample(np.random.default_rng(3), 4)
        got, want = many.evaluate_genomes(space, pop), one.evaluate_genomes(
            space, pop)
        fields = ("latency", "throughput")
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
