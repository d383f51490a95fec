"""The port's load propagation (plain versions and dispatch) against
``repro.kernels.ops.load_propagate``: the Pallas kernel in interpret mode at
n <= 16, the XLA dense and blocked forms up to n = 64, batched, with
unreachable pairs. Tolerance: W and flow within rtol 1e-5 / atol 1e-6 (sums
taken in another order; the same bound the reference holds its own
backends to)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (first: repro.routing needs repro.core loaded)
import jax.numpy as jnp
from repro.kernels.ops import load_propagate as ref_load_propagate
from repro.routing.device import hops_next_hop_batch

from repro_torch.kernels import build, load_prop
from repro_torch.kernels.ops import load_propagate
from repro_torch.utils import env

RTOL, ATOL = 1e-5, 1e-6


def _random_table(n: int, rng, connected: bool = True) -> np.ndarray:
    """Next-hop table of a random graph (BFS, lowest-id ties); with
    ``connected=False`` the last quarter of the vertices is isolated, so
    their pairs self-loop (unreachable)."""
    adj = np.zeros((n, n), bool)
    m = n if connected else n - max(1, n // 4)
    perm = rng.permutation(m)
    for i in range(1, m):
        j = perm[rng.integers(0, i)]
        adj[perm[i], j] = adj[j, perm[i]] = True
    for _ in range(2 * m):
        u, v = rng.integers(0, m, 2)
        if u != v:
            adj[u, v] = adj[v, u] = True
    return np.asarray(hops_next_hop_batch(jnp.asarray(adj[None])))[0]


def _load0(n: int, rng) -> np.ndarray:
    l0 = rng.random((n, n)).astype(np.float32)
    np.fill_diagonal(l0, 0.0)
    return l0


def _batch(rng, batch: int, n: int):
    nh = np.stack([_random_table(n, rng, connected=b % 2 == 0)
                   for b in range(batch)]).astype(np.int32)
    l0 = np.stack([_load0(n, rng) for _ in range(batch)])
    return nh, l0


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [6, 11, 16])
def test_plain_matches_pallas_interpret(n):
    rng = np.random.default_rng(n)
    nh, l0 = _batch(rng, 2, n)
    want = ref_load_propagate(jnp.asarray(nh), jnp.asarray(l0),
                              backend="pallas_interpret")
    got = load_propagate(torch.from_numpy(nh), torch.from_numpy(l0))
    _assert_close(got, want)


@pytest.mark.parametrize("n,batch", [(8, 1), (24, 3), (40, 4), (64, 2)])
@pytest.mark.parametrize("adaptive", [True, False])
def test_plain_matches_xla(n, batch, adaptive):
    rng = np.random.default_rng(100 + n)
    nh, l0 = _batch(rng, batch, n)
    want = ref_load_propagate(jnp.asarray(nh), jnp.asarray(l0),
                              backend="xla", adaptive=adaptive)
    got = load_propagate(torch.from_numpy(nh), torch.from_numpy(l0),
                         adaptive=adaptive)
    _assert_close(got, want)


@pytest.mark.parametrize("n,tile", [(20, 8), (36, 32), (64, 16)])
def test_slab_form_matches_xla_blocked(n, tile):
    rng = np.random.default_rng(200 + n)
    nh, l0 = _batch(rng, 3, n)
    with env.override(REPRO_LOAD_PROP_FUSED_N=1, REPRO_LOAD_PROP_TILE=tile):
        got = load_propagate(torch.from_numpy(nh), torch.from_numpy(l0),
                             max_hops=n - 1)
    want = ref_load_propagate(jnp.asarray(nh), jnp.asarray(l0),
                              max_hops=n - 1, backend="xla_blocked")
    _assert_close(got, want)


@pytest.mark.parametrize("n", [16, 36, 100])
def test_kernel_slab_emulation_matches_dense(n):
    """The slab form at the kernel's own tile (ragged last slab for
    n = 36 and 100) equals the dense form within the stated tolerance."""
    rng = np.random.default_rng(300 + n)
    nh, l0 = _batch(rng, 2, n)
    nh_t, l0_t = torch.from_numpy(nh), torch.from_numpy(l0)
    dense = load_prop.load_prop_plain(nh_t, l0_t, n - 1, adaptive=False)
    slab = load_prop.load_prop_plain_blocked(nh_t, l0_t, n - 1, False,
                                             load_prop.cuda_tile(n))
    _assert_close(slab, dense)


def test_fixed_hops_equal_adaptive_on_connected_designs():
    rng = np.random.default_rng(4)
    nh = np.stack([_random_table(12, rng) for _ in range(3)])
    l0 = np.stack([_load0(12, rng) for _ in range(3)])
    nh_t, l0_t = torch.from_numpy(nh), torch.from_numpy(l0)
    for fn in (lambda a: load_prop.load_prop_plain(nh_t, l0_t, 11, a),
               lambda a: load_prop.load_prop_plain_blocked(nh_t, l0_t, 11, a,
                                                           5)):
        w_a, f_a = fn(True)
        w_f, f_f = fn(False)
        assert torch.equal(w_a, w_f) and torch.equal(f_a, f_f)


def test_unreachable_pairs_pile_up_for_every_hop():
    """An isolated design never delivers: every unit pays max_hops
    self-hops and the flow sits on the diagonal."""
    n = 8
    nh = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, n))
    l0 = _load0(n, np.random.default_rng(5))
    _, flow = load_propagate(torch.from_numpy(nh), torch.from_numpy(l0))
    np.testing.assert_allclose(np.diag(flow.numpy()),
                               l0.sum(axis=0) * (n - 1), rtol=RTOL)
    assert np.count_nonzero(flow.numpy() - np.diag(np.diag(flow.numpy()))) == 0


def test_cpu_tensors_never_reach_the_kernel():
    rng = np.random.default_rng(6)
    nh, l0 = _batch(rng, 2, 10)
    before = load_prop.load_prop_cuda.launches
    load_propagate(torch.from_numpy(nh), torch.from_numpy(l0))
    assert load_prop.load_prop_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        load_prop.load_prop_cuda(torch.from_numpy(nh), torch.from_numpy(l0), 4)


def test_kernel_tiles_depend_on_n_only():
    for n in (1, 16, 36, 64, 128, 160, 256, 1024, 4096):
        tile, rows = load_prop.cuda_tile(n), load_prop.cuda_flow_rows(n)
        assert 1 <= tile <= min(32, n) and 1 <= rows <= min(32, n)
        assert load_prop._hops_smem(n, tile) <= load_prop.SMEM_MAX
        assert tile == 1 or load_prop._hops_smem(n, tile) <= 48 * 1024
    with pytest.raises(ValueError):
        load_prop.cuda_tile(20000)


def test_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the build raise; nothing is loaded."""
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_all()
    assert not list(tmp_path.glob("*.so"))
