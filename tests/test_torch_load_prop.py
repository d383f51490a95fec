"""The port's load propagation (plain versions and dispatch) against
``repro.kernels.ops.load_propagate``: the Pallas kernel in interpret mode at
n <= 16, the XLA dense and blocked forms up to n = 161, batched, with
unreachable pairs. Tolerance: W and flow within rtol 1e-5 / atol 1e-6 (sums
taken in another order; the same bound the reference holds its own
backends to). The CUDA kernel pair cannot run here, so its decomposition is
emulated step by step (the warp's inversion, the per-row hop loop, the
gathered flow) and held bit-equal to an emulation of the first design's
order, and its launch plan is checked to depend on n only."""
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


@pytest.mark.parametrize("n", [32, 64, 128, 160])
def test_dense_form_rows_alone_equal_rows_in_a_batch(n):
    """Each row of a B = 7 batch through the dense CPU form is bit-equal to
    the same row run alone (B = 1), the case of a one-row population shard,
    and the batch stays within the stated tolerance of the reference."""
    rng = np.random.default_rng(500 + n)
    nh, l0 = _batch(rng, 7, n)
    nh_t, l0_t = torch.from_numpy(nh), torch.from_numpy(l0)
    w, flow = load_propagate(nh_t, l0_t)
    for b in range(7):
        w1, f1 = load_propagate(nh_t[b:b + 1], l0_t[b:b + 1])
        assert torch.equal(w1[0], w[b]) and torch.equal(f1[0], flow[b]), b
    want = ref_load_propagate(jnp.asarray(nh), jnp.asarray(l0),
                              backend="xla")
    _assert_close((w, flow), want)


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
        # one warp a row, 8 a CTA unless n or the shared memory allows fewer
        assert tile == min(load_prop.MAX_SLAB_ROWS, n,
                           load_prop.SMEM_MAX // load_prop._hops_smem(n, 1))
    with pytest.raises(ValueError):
        load_prop.cuda_tile(20000)


def test_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the build raise; nothing is loaded."""
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build_all()
    assert not list(tmp_path.glob("*.so"))


# -- the hand-written kernel pair's decomposition, emulated on the CPU ------
# (csrc/load_prop.cu cannot run here; these emulations follow its steps)

NONE = 0xFFFF        # the kernel's uint16 key for a dropped entry


def _peers(v: np.ndarray, bits: int) -> np.ndarray:
    """``peers_of`` of csrc/load_prop.cu for a warp's 32 values: per lane,
    the mask of lanes whose value agrees on each of ``bits`` ballots."""
    peers = np.full(32, 0xFFFFFFFF, np.int64)
    for b in range(bits):
        bit = (v >> b) & 1
        ones = int(sum(1 << lane for lane in range(32) if bit[lane]))
        peers &= np.where(bit == 1, ones, ~ones & 0xFFFFFFFF)
    return peers


def _warp_invert(key: np.ndarray, n: int):
    """``warp_invert`` of csrc/load_prop.cu, lane by lane: counts (integer
    atomics, so in any order), a chunked inclusive prefix sum packed as
    end | end << 16, and a placement pass over 32-index chunks from the
    top down: each lane finds its peers (lanes of equal value, from one
    ballot per bit, a dropped entry marked n), puts its index at its
    group's end minus its rank among its peers, then the group's lowest
    lane lowers the end. Returns (start, end, lst)."""
    key = np.where((key >= 0) & (key < n), key, NONE).astype(np.int64)
    rng_ = np.bincount(key[key < n], minlength=n).astype(np.int64)
    lst = np.full(n, -1, np.int64)
    carry = 0
    for v0 in range(0, n, 32):
        x = np.cumsum(rng_[v0:v0 + 32]) + carry
        rng_[v0:v0 + 32] = x | (x << 16)
        carry = x[-1]
    bits = int(n).bit_length()
    for c in reversed(range(-(-n // 32))):
        i = c * 32 + np.arange(32)
        v = np.where(i < n, key[np.minimum(i, n - 1)], n)
        v = np.where(v < n, v, n)
        peers = _peers(v, bits)
        for lane in np.flatnonzero(v < n):
            size = bin(int(peers[lane])).count("1")
            rank = bin(int(peers[lane]) & ((1 << lane) - 1)).count("1")
            assert size == (v == v[lane]).sum()
            lst[(rng_[v[lane]] & 0xFFFF) - size + rank] = i[lane]
        for lane in np.flatnonzero(v < n):
            if (int(peers[lane]) & -int(peers[lane])) == 1 << lane:
                rng_[v[lane]] -= bin(int(peers[lane])).count("1")
    return rng_ & 0xFFFF, rng_ >> 16, lst


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 161])
@pytest.mark.parametrize("kind", ["table", "one_value", "out_of_range"])
def test_warp_ranked_inversion_equals_a_stable_argsort(n, kind):
    """The lists come out as a stable argsort of the keys: v's indices in
    ascending order, in ascending v; entries outside [0, n) are dropped."""
    rng = np.random.default_rng(n)
    key = rng.integers(0, n, n)
    if kind == "one_value":                  # one group of n peers
        key[:] = n // 2
    elif kind == "out_of_range":
        key = rng.integers(-3, n + 3, n)
    start, end, lst = _warp_invert(key, n)
    valid = (key >= 0) & (key < n)
    counts = np.bincount(key[valid], minlength=n)
    np.testing.assert_array_equal(end - start, counts)
    np.testing.assert_array_equal(start, np.cumsum(counts) - counts)
    order = np.argsort(np.where(valid, key, n), kind="stable")
    np.testing.assert_array_equal(lst[:valid.sum()], order[:valid.sum()])
    assert (lst[valid.sum():] == -1).all()


def _pred_lists(next_hop: np.ndarray):
    """Per (design, row d, value v): v's predecessors u (next_hop[u, d] ==
    v) in ascending u, as [B, n, n, L] indices and a mask (the inversion,
    which ``test_warp_ranked_inversion_equals_a_stable_argsort`` holds to
    a stable argsort)."""
    B, n, _ = next_hop.shape
    key = next_hop.transpose(0, 2, 1)                     # [B, d, u] -> v
    key = np.where((key >= 0) & (key < n), key, n)
    order = np.argsort(key, axis=-1, kind="stable")
    counts = (key[..., None] == np.arange(n)).sum(axis=-2)  # [B, d, v]
    starts = np.cumsum(counts, axis=-1) - counts
    width = max(1, int(counts.max()))
    k = np.arange(width)
    idx = np.minimum(starts[..., None] + k, n - 1).reshape(B, n, n * width)
    preds = np.take_along_axis(order, idx, axis=-1).reshape(B, n, n, width)
    return preds, k < counts[..., None]


def _emulate_hops(next_hop, load0, max_hops: int, stop_rows: int):
    """W in the kernel's order: per hop, W[d] += L[d] first, then L'[d, v]
    sums v's predecessors' L[d, u] in ascending u from 0.f (L'[d, d] = 0);
    a group of ``stop_rows`` consecutive rows stops once all its L' are
    zero (1: the redesign, one warp a row; the first design's slab: a
    block-wide OR)."""
    B, n, _ = next_hop.shape
    preds, mask = _pred_lists(next_hop)
    offdiag = np.arange(n)[:, None] != np.arange(n)
    cur = np.where(offdiag, load0, np.float32(0)).astype(np.float32)
    acc = np.zeros_like(cur)
    active = np.ones((B, n), bool)
    groups = np.arange(n) // stop_rows
    for _ in range(max_hops):
        acc = np.where(active[..., None], acc + cur, acc)
        s = np.zeros_like(cur)
        for k in range(preds.shape[-1]):
            g = np.take_along_axis(cur, preds[..., k], axis=-1)
            s = np.where(mask[..., k], s + g, s)
        nxt = np.where(offdiag, s, np.float32(0))
        live = (nxt != 0).any(axis=-1)                       # [B, d]
        group_live = np.zeros((B, groups[-1] + 1), bool)
        np.logical_or.at(group_live, (slice(None), groups), live)
        active &= group_live[:, groups]
        cur = nxt
        if not active.any():
            break
    return acc


def _emulate_flow_gather(next_hop, w):
    """The redesign's flow: per source row u, v's list of d (ascending)
    from the inverted row next_hop[u, :]; flow[u, v] sums W[d, u] over it
    from 0.f."""
    B, n, _ = next_hop.shape
    # the inversion of row u is _pred_lists of the transposed table
    preds, mask = _pred_lists(next_hop.transpose(0, 2, 1))   # [B, u, v, L]
    wt = w.transpose(0, 2, 1)                                # [B, u, d]
    s = np.zeros((B, n, n), np.float32)
    for k in range(preds.shape[-1]):
        g = np.take_along_axis(wt, preds[..., k], axis=-1)
        s = np.where(mask[..., k], s + g, s)
    return s


def _emulate_flow_walk(next_hop, w):
    """The first design's flow: one thread per source row u walks d in
    ascending order and adds W[d, u] into flow[u, next_hop[u, d]]."""
    B, n, _ = next_hop.shape
    flow = np.zeros((B, n, n), np.float32)
    b, u = np.meshgrid(np.arange(B), np.arange(n), indexing="ij")
    for d in range(n):
        v = next_hop[:, :, d]
        ok = (v >= 0) & (v < n)
        vv = np.where(ok, v, 0)
        flow[b, u, vv] = np.where(ok, flow[b, u, vv] + w[:, d, :],
                                  flow[b, u, vv])
    return flow


def _first_tile(n: int) -> int:
    """The first design's destination rows a CTA (as many as fit in 48 KB,
    at most 32): its slab stops on a block-wide OR."""
    return max(1, min(32, n, 48 * 1024 // (16 * n + 2)))


@pytest.mark.parametrize("n", [16, 33, 100, 161])
def test_emulated_kernel_orders_bit_equal_to_the_first_design(n):
    """W and flow in the redesign's order (per-row stops, warp-built lists,
    the gathered flow) are bit-equal to the first design's (slab stops,
    the walked flow), ragged last slabs and unreachable pairs included, and
    within rtol 1e-5 / atol 1e-6 of the reference."""
    rng = np.random.default_rng(400 + n)
    nh, l0 = _batch(rng, 2, n)
    hops = n - 1
    w_new = _emulate_hops(nh, l0, hops, stop_rows=1)
    w_first = _emulate_hops(nh, l0, hops, stop_rows=_first_tile(n))
    np.testing.assert_array_equal(w_new, w_first)
    f_new = _emulate_flow_gather(nh, w_new)
    f_first = _emulate_flow_walk(nh, w_first)
    np.testing.assert_array_equal(f_new, f_first)
    backend = "xla_blocked" if n > 160 else "xla"
    want = ref_load_propagate(jnp.asarray(nh), jnp.asarray(l0),
                              max_hops=hops, backend=backend, adaptive=False)
    _assert_close((w_new, f_new), want)
    # and the port's plain version, which the card holds the kernel to
    got = load_propagate(torch.from_numpy(nh), torch.from_numpy(l0), hops)
    _assert_close((w_new, f_new), got)


@pytest.mark.parametrize("n", [1, 7, 8, 32, 128, 256, 341, 342, 1024, 12913])
def test_launch_plan_depends_on_n_only_and_fits(n):
    plans = [load_prop.cuda_plan(n, b) for b in (1, 7, 256)]
    for p, b in zip(plans, (1, 7, 256)):
        assert p["hop_ctas"] == b * -(-n // p["tile"])
        assert p["flow_ctas"] == b * -(-n // p["flow_rows"])
        drop = ("hop_ctas", "flow_ctas")
        assert {k: v for k, v in p.items() if k not in drop} == {
            k: v for k, v in plans[0].items() if k not in drop}
        assert p["hop_smem"] <= load_prop.SMEM_MAX
        assert p["flow_smem"] <= load_prop.SMEM_MAX
        assert 32 <= p["hop_threads"] <= 256 and 32 <= p["flow_threads"] <= 256
    assert (plans[0]["hop_smem"] <= load_prop.SMEM_DEFAULT) == (n <= 341)
