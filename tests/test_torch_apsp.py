"""The port's ``kernels.ops.apsp`` on the CPU against the JAX package's
``repro.kernels.ops.apsp``: the fused Pallas kernel in interpret mode at
n <= 16, the XLA dense and blocked forms up to n = 64 with ragged tiles,
and the promotion above ``REPRO_APSP_FUSED_N``. Tolerance: none. Each
squaring reads only the previous iterate and min is exact, so every form
must agree bit for bit; disconnected pairs stay +inf. The CUDA kernel's
schedule (bands over a thread block cluster, a stop at the fixed point) is
emulated and held bit-equal to every squaring of the plain version."""
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
    """Two f32 panes stop fitting above MAX_FUSED_N; there the cluster
    kernel's layout (two [n, ld] panes and 2 x 8 int flags, rows padded to
    2 floats) still fits."""
    n = apsp_mod.MAX_FUSED_N
    assert 2 * n * n * 4 <= apsp_mod.SMEM_MAX < 2 * (n + 1) ** 2 * 4
    p = apsp_mod.fused_plan(n)
    assert (p["ld"], p["w"]) == (170, 2)
    assert p["smem"] == 2 * n * p["ld"] * 4 + 2 * 8 * 4 <= apsp_mod.SMEM_MAX


# -- the cluster kernel's schedule, emulated on the CPU ----------------------
# (csrc/apsp.cu cannot run here; this follows its steps)


def _prepare(d: np.ndarray) -> torch.Tensor:
    """The operand as ``ops.apsp`` hands it to the kernel: BIG for "no
    edge", zero diagonal."""
    t = torch.from_numpy(d)
    t = torch.clamp_max(torch.where(torch.isfinite(t), t, BIG), BIG)
    eye = torch.eye(t.shape[-1], dtype=torch.bool)
    return torch.minimum(t, torch.where(eye, 0.0, BIG))


def _differs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bits changed, or a NaN (the kernel's ``differs``)."""
    return (a.view(torch.int32) != b.view(torch.int32)) | torch.isnan(a)


def _emulate_cluster(d: torch.Tensor, n_iters: int):
    """One design through csrc/apsp.cu's schedule: each squaring, every
    rank r of the cluster computes its band of rows from the whole current
    iterate (min of the entry and of every candidate over k) and all bands
    make the next iterate; the design stops once no rank's band changed.
    Returns (the result, the squarings run)."""
    n = d.shape[-1]
    plan = apsp_mod.fused_plan(n)
    cur = d
    for it in range(n_iters):
        bands, changed = [], False
        for r in range(plan["cluster"]):
            r0 = min(n, r * plan["band"])
            r1 = min(n, r0 + plan["band"])
            rows = cur[r0:r1]
            cand = (rows[:, :, None] + cur[None, :, :]).amin(dim=1)
            band = torch.minimum(rows, cand)
            changed |= bool(_differs(band, rows).any())
            bands.append(band)
        if not changed:
            return cur, it + 1
        cur = torch.cat(bands)
    return cur, n_iters


@pytest.mark.parametrize("n", [6, 16, 33, 64, 100, 170])
def test_cluster_bands_with_early_stop_bit_equal_to_plain(n):
    """The band split across the cluster, stopping at the fixed point, is
    bit-equal to all n_iters squarings of ``apsp_plain`` and to the
    reference (the Pallas kernel in interpret mode at n <= 16)."""
    from repro_torch.kernels.ops import apsp_iters

    d = _random_costs(np.random.default_rng(300 + n), 3, n)
    prep = _prepare(d)
    it = apsp_iters(n)
    want = apsp_mod.apsp_plain(prep, it)
    got = torch.stack([_emulate_cluster(prep[b], it)[0] for b in range(3)])
    assert torch.equal(got, want)
    backend = "pallas_interpret" if n <= 16 else "xla"
    ref = np.asarray(ref_apsp(jnp.asarray(d), backend=backend))
    np.testing.assert_array_equal(
        torch.where(got >= BIG * 0.5, torch.inf, got).numpy(), ref)


def test_design_converging_after_two_of_seven_squarings():
    """A 64-node design of diameter 4 (a path 0-1-2-3-4 with every other
    node hung on node 2) converges after 2 squarings: the emulated kernel
    stops after the third, which changes nothing, and gives the bits of all
    7 squarings."""
    from repro_torch.kernels.ops import apsp_iters

    n = 64
    d = np.full((n, n), np.inf, np.float32)
    for u, v in [(0, 1), (1, 2), (2, 3), (3, 4)] + [(2, v)
                                                    for v in range(5, n)]:
        d[u, v] = d[v, u] = 1.0
    prep = _prepare(d)
    assert apsp_iters(n) == 7
    got, run = _emulate_cluster(prep, 7)
    assert run == 3
    assert torch.equal(got, apsp_mod.apsp_plain(prep[None], 7)[0])
    assert torch.equal(apsp_mod.apsp_plain(prep[None], 2),
                       apsp_mod.apsp_plain(prep[None], 7))
    assert not torch.equal(apsp_mod.apsp_plain(prep[None], 1),
                           apsp_mod.apsp_plain(prep[None], 7))
    assert got.max() == 4.0


@pytest.mark.parametrize("n", [*range(1, apsp_mod.MAX_FUSED_N, 13), 168,
                               169, 170])
def test_fused_plan_depends_on_n_only_and_fits(n):
    p = apsp_mod.fused_plan(n)
    c, band = p["cluster"], p["band"]
    assert c in (1, 2, 4, 8) and (c == 8 or c * 8 >= n)
    assert band == -(-n // c)              # the ranks' bands cover n rows
    assert p["ld"] % p["w"] == 0 and n <= p["ld"] < n + p["w"]
    assert p["smem"] <= apsp_mod.SMEM_MAX
    assert p["mi"] == (1 if band * n <= 512 else 2)
    assert p["w"] == 2 if band * n <= 512 or n >= 169 else p["w"] == 4
