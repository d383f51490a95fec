"""The port's ``kernels.ops.apsp`` on the CPU against the JAX package's
``repro.kernels.ops.apsp``: the fused Pallas kernel in interpret mode at
n <= 16, the XLA dense and blocked forms up to n = 64 with ragged tiles,
and the promotion above ``REPRO_APSP_FUSED_N``. Tolerance: none. Each
squaring reads only the previous iterate and min is exact, so every form
must agree bit for bit; disconnected pairs stay +inf."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: F401  (first: repro's modules need repro.core loaded)
import jax.numpy as jnp
from repro.kernels.ops import apsp as ref_apsp

from repro_torch.kernels import apsp as apsp_mod
from repro_torch.kernels.ops import apsp, minplus_matmul
from repro_torch.kernels.ref import BIG


def _random_costs(rng, batch: int, n: int, connected: bool = False):
    """Symmetric integer step costs in [1, 4]; unless ``connected``, the
    last quarter of the vertices is cut off (their pairs are +inf)."""
    out = np.full((batch, n, n), np.inf, np.float32)
    m = n if connected else n - max(1, n // 4)
    for b in range(batch):
        perm = rng.permutation(m)
        for i in range(1, m):
            j = perm[rng.integers(0, i)]
            out[b, perm[i], j] = out[b, j, perm[i]] = rng.integers(1, 5)
        for _ in range(m):
            u, v = rng.integers(0, m, 2)
            if u != v:
                out[b, u, v] = out[b, v, u] = rng.integers(1, 5)
    return out


def _both(d, backend, **kw):
    want = np.asarray(ref_apsp(jnp.asarray(d), backend=backend, **kw))
    got = apsp(torch.from_numpy(d), **kw).numpy()
    return got, want


@pytest.mark.parametrize("n", [6, 11, 16])
def test_fused_matches_pallas_interpret(n):
    d = _random_costs(np.random.default_rng(n), 3, n)
    got, want = _both(d, "pallas_interpret")
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[:, -1, 0]).all()          # cut-off vertex
    assert np.isfinite(got[:, :n - max(1, n // 4), :n - max(1, n // 4)]).all()


@pytest.mark.parametrize("n", [20, 37, 64])
def test_fused_matches_xla(n):
    d = _random_costs(np.random.default_rng(100 + n), 2, n)
    got, want = _both(d, "xla")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tile", [3, 5, 16])
def test_blocked_matches_xla_blocked_with_ragged_tiles(monkeypatch, tile):
    monkeypatch.setenv("REPRO_APSP_TILE", str(tile))
    monkeypatch.setenv("REPRO_APSP_FUSED_N", "8")
    rng = np.random.default_rng(20 + tile)
    for n in (13, 20, 41):
        d = _random_costs(rng, 2, n)
        got, want = _both(d, "xla_blocked")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _both(d, "xla")[1])


def test_promotion_above_fused_n(monkeypatch):
    d = _random_costs(np.random.default_rng(22), 2, 30)
    monkeypatch.setenv("REPRO_APSP_FUSED_N", "16")
    promoted, want = _both(d, "xla")          # both sides promote to blocked
    monkeypatch.setenv("REPRO_APSP_FUSED_N", "1000")
    np.testing.assert_array_equal(promoted, want)
    np.testing.assert_array_equal(apsp(torch.from_numpy(d)).numpy(), want)


def test_beyond_fused_kernel_limit_iterates_minplus(monkeypatch):
    """A fused size the kernel cannot hold runs the tiled squaring (iterated
    min-plus), not the fused form."""
    n = apsp_mod.MAX_FUSED_N + 5
    monkeypatch.setenv("REPRO_APSP_FUSED_N", str(n))
    calls = []
    real = apsp_mod.apsp_plain_blocked
    monkeypatch.setattr(apsp_mod, "apsp_plain_blocked",
                        lambda *a: calls.append(a[2]) or real(*a))
    monkeypatch.setattr(apsp_mod, "apsp_plain", None)
    d = _random_costs(np.random.default_rng(23), 1, n)
    got, want = _both(d, "xla")
    assert calls
    np.testing.assert_array_equal(got, want)


def test_two_dimensional_input_and_explicit_iterations():
    d = _random_costs(np.random.default_rng(24), 1, 12, connected=True)[0]
    for n_iters in (1, 2, 5):
        got, want = _both(d, "xla", n_iters=n_iters)
        assert got.shape == (12, 12)
        np.testing.assert_array_equal(got, want)


def test_plain_forms_agree_bit_for_bit():
    d = torch.from_numpy(_random_costs(np.random.default_rng(25), 3, 29))
    d = torch.minimum(torch.where(torch.isfinite(d), d, BIG),
                      torch.where(torch.eye(29, dtype=torch.bool), 0.0, BIG))
    dense = apsp_mod.apsp_plain(d, 6)
    for tile in (1, 4, 7, 29, 64):
        assert torch.equal(apsp_mod.apsp_plain_blocked(d, 6, tile), dense)
    it = d
    for _ in range(6):
        it = minplus_matmul(it, it)
    assert torch.equal(it, dense)


def test_kernel_wrappers_refuse_cpu_tensors():
    d = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        apsp_mod.apsp_fused_cuda(d, 2)
    with pytest.raises(ValueError, match="CUDA"):
        apsp_mod.apsp_square_cuda(d, 2)


def test_max_fused_n_fits_two_panes_in_shared_memory():
    n = apsp_mod.MAX_FUSED_N
    assert 2 * n * n * 4 <= apsp_mod.SMEM_MAX < 2 * (n + 1) ** 2 * 4
