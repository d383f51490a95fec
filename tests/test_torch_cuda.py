"""The port's CUDA load-propagation kernel on the card: against its plain
version, alone vs in a batch, and the wrapper's refusals. Every test here
needs an NVIDIA Hopper GPU and skips without one; run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports nothing of ``repro``: the machine with the card has no
JAX. Tolerance: W and flow within rtol 1e-5 / atol 1e-6 of the plain
version (the kernel sums each entry in ascending source order, the plain
version's einsum in its own order).
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
