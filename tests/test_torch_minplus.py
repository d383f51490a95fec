"""The port's min-plus product and ``path_cost_minplus`` against the JAX
package on the CPU: ``repro.kernels.ops.minplus_matmul`` runs its Pallas
kernel in interpret mode here, as ``tests/test_kernels.py`` runs it.
Tolerance: none. Every candidate is one f32 add and min is exact in any
order, so the port's plain version must equal the kernel bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (first: repro's modules need repro.core loaded)
import jax.numpy as jnp
from repro.core import path_cost_minplus as ref_path_cost_minplus
from repro.core.graph import build_graph as ref_build_graph
from repro.core.graph import step_cost_matrix as ref_step_cost_matrix
from repro.kernels.ops import minplus_matmul as ref_minplus_matmul
from repro.topologies import make_design as ref_make_design

import repro_torch.core  # noqa: F401
from repro_torch.core.latency import path_cost_minplus
from repro_torch.kernels import minplus
from repro_torch.kernels.ops import minplus_matmul
from repro_torch.kernels.ref import BIG, minplus_ref


def _operands(rng, shape_a, shape_b):
    """Uniform costs with ~20% BIG entries in a and ~20% +inf in b."""
    a = rng.uniform(0.0, 50.0, shape_a).astype(np.float32)
    b = rng.uniform(0.0, 50.0, shape_b).astype(np.float32)
    a[rng.random(a.shape) < 0.2] = BIG
    b[rng.random(b.shape) < 0.2] = np.inf
    return a, b


@pytest.mark.parametrize("B,M,K,N", [
    (1, 1, 1, 1), (2, 37, 13, 9), (1, 130, 70, 200), (3, 60, 60, 60),
    (1, 37, 128, 1), (2, 8, 200, 37),
])
def test_plain_equals_reference_kernel_bit_for_bit(B, M, K, N):
    rng = np.random.default_rng(B * 1000 + M * 10 + K + N)
    a, b = _operands(rng, (B, M, K), (B, K, N))
    want = np.asarray(ref_minplus_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = minplus_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() <= np.float32(BIG)


def test_two_dimensional_operands():
    rng = np.random.default_rng(5)
    a, b = _operands(rng, (23, 17), (17, 41))
    want = np.asarray(ref_minplus_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = minplus_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (23, 41)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_row_chunks_do_not_change_bits(monkeypatch):
    rng = np.random.default_rng(6)
    a, b = _operands(rng, (2, 50, 30), (2, 30, 20))
    whole = minplus.minplus_plain(torch.from_numpy(a), torch.from_numpy(b))
    monkeypatch.setattr(minplus, "_CHUNK_ELEMS", 7 * 30 * 20)
    chunked = minplus.minplus_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(whole, chunked)
    ref = torch.clamp_max(minplus_ref(torch.from_numpy(a),
                                      torch.from_numpy(b)), BIG)
    assert torch.equal(whole, ref)


def test_min_plus_identity():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.uniform(0, 50, (40, 40)).astype(np.float32))
    eye = torch.where(torch.eye(40, dtype=torch.bool), 0.0, BIG)
    assert torch.equal(minplus_matmul(a, eye), a)


def test_kernel_wrapper_refuses_cpu_tensors():
    a = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        minplus.minplus_cuda(a, a)


def test_other_devices_are_refused():
    a = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        minplus_matmul(a, a)


def _mesh_costs(topology: str, n: int):
    design = ref_make_design(topology, n, routing_metric="latency")
    g = ref_build_graph(design)
    sc = ref_step_cost_matrix(g)
    sc = np.where(np.isfinite(sc), sc, np.inf).astype(np.float32)
    return sc, np.asarray(g.node_weight, np.float32)


@pytest.mark.parametrize("topology,n", [("mesh", 16), ("kite", 16)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_path_cost_minplus_matches_reference(topology, n, use_kernel):
    sc, nw = _mesh_costs(topology, n)
    want = np.asarray(ref_path_cost_minplus(jnp.asarray(sc), jnp.asarray(nw),
                                            use_kernel=use_kernel))
    got = path_cost_minplus(torch.from_numpy(sc), torch.from_numpy(nw),
                            use_kernel=use_kernel).numpy()
    np.testing.assert_array_equal(got, want)


def test_path_cost_minplus_kernel_route_equals_plain_and_batches():
    sc, nw = _mesh_costs("mesh", 25)
    sc_t, nw_t = torch.from_numpy(sc), torch.from_numpy(nw)
    plain = path_cost_minplus(sc_t, nw_t, use_kernel=False)
    kern = path_cost_minplus(sc_t, nw_t, use_kernel=True)
    assert torch.equal(plain, kern)
    batch = path_cost_minplus(torch.stack([sc_t, sc_t]),
                              torch.stack([nw_t, nw_t]), use_kernel=True)
    assert torch.equal(batch[1], kern)


@pytest.mark.parametrize("B,M,K,N,tile,split", [
    (8, 256, 256, 64, 64, 8),       # the genome selection's slab product
    (3, 256, 256, 256, 64, 4),      # the tiled APSP squaring at n = 256
    (32, 32, 32, 32, 32, 2),        # the n = 32 genome selection
    (64, 200, 200, 200, 64, 1),     # a batch that fills the card alone
    (1, 64, 31, 64, 64, 1), (1, 64, 32, 64, 64, 2),
    (1, 64, 127, 64, 64, 4), (1, 64, 128, 64, 64, 8),
    (3, 63, 100, 64, 32, 4), (2, 5, 0, 7, 32, 1),
])
def test_launch_plan(B, M, K, N, tile, split):
    """``minplus_plan`` (the mirror of the launch's plan): a 64 x 64 tile
    only where M and N are both at least 64; k split over a cluster of up to
    8 CTAs until the grid fills the H100's 132 SMs, each CTA keeping at
    least 16 k and every CTA some k; the paths' shapes reach 132 CTAs."""
    p = minplus.minplus_plan(B, M, K, N)
    assert (p["tile"], p["split"]) == (tile, split)
    assert p["threads"] == (tile // 4) ** 2
    assert p["ctas"] == B * -(-M // tile) * -(-N // tile) * split
    assert p["k_per_cta"] % minplus.DEPTH == 0
    assert p["split"] * p["k_per_cta"] >= K
    if split > 1:
        assert (split - 1) * p["k_per_cta"] < K
        assert K // split >= minplus.DEPTH
    if (B, M, K, N) in ((8, 256, 256, 64), (3, 256, 256, 256)):
        assert p["ctas"] >= minplus.FILL_CTAS


def _k_split_merge(a, b):
    """A plain emulation of the kernel's k split: each CTA rank's partial
    minimum over its share of k (BIG where the share is empty), merged in
    rank order."""
    B, M, K = a.shape
    p = minplus.minplus_plan(B, M, K, b.shape[-1])
    kc = p["k_per_cta"]
    merged = None
    for r in range(p["split"]):
        kb, ke = min(K, r * kc), min(K, (r + 1) * kc)
        part = minplus.minplus_plain(a[:, :, kb:ke].contiguous(),
                                     b[:, kb:ke].contiguous())
        merged = part if merged is None else torch.minimum(merged, part)
    return merged, p["split"]


@pytest.mark.parametrize("B,M,K,N", [
    (8, 256, 256, 64), (3, 256, 256, 256), (32, 32, 32, 32),
    (1, 64, 129, 64), (2, 70, 255, 65), (3, 63, 100, 64), (1, 31, 64, 33),
])
def test_k_split_merge_bit_equal_to_plain_and_reference(B, M, K, N):
    """Min is exact and each candidate one f32 add, so the split the plan
    picks, merged in rank order, equals the unsplit product and the
    reference's Pallas kernel (interpret mode) bit for bit."""
    rng = np.random.default_rng(B + M + K + N)
    a, b = _operands(rng, (B, M, K), (B, K, N))
    merged, split = _k_split_merge(torch.from_numpy(a), torch.from_numpy(b))
    assert split > 1
    whole = minplus.minplus_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(merged, whole)
    want = np.asarray(ref_minplus_matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(merged.numpy(), want)
