"""The port's flow accumulation (B6's plain version) and the pair-walk
throughput oracle against the reference on the CPU, and the repaired
positional signatures of ``edge_flows`` and ``throughput_proxy``.

Tolerances: ``flow_accumulate`` within rtol 1e-6 / atol 1e-6 of the
reference kernel in interpret mode (its one-hot matmul sums the pairs in
another order; the reference's own test allows rtol 1e-4 / atol 1e-5) and
bit-equal to a sequential scatter in ascending p; throughput within rtol
1e-5 (f32 sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import repro.core  # noqa: F401  (the reference's import order)
from repro.core import prepare_arrays as ref_prepare_arrays
from repro.core import throughput as ref_throughput
from repro.core.latency import routed_diameter as ref_routed_diameter
from repro.kernels.ops import flow_accumulate as ref_flow_accumulate
from repro.topologies import TOPOLOGIES
from repro.topologies import make_design as ref_make_design
from repro.traffic import make_traffic as ref_make_traffic

from repro_torch.core import prepare_arrays, throughput
from repro_torch.kernels import flow_accum as fa
from repro_torch.kernels.ops import flow_accumulate
from repro_torch.kernels.ref import flow_accumulate_ref
from repro_torch.topologies import make_design
from repro_torch.traffic import make_traffic

RTOL = 1e-5


def _pairs(rng, shape, n):
    return (rng.integers(0, n, shape).astype(np.int32),
            rng.integers(0, n, shape).astype(np.int32),
            rng.uniform(0, 2, shape).astype(np.float32))


@pytest.mark.parametrize("n,p", [(8, 64), (16, 100), (100, 10000), (128, 512),
                                 (9, 81), (2, 4)])
def test_flow_accumulate_matches_reference(n, p):
    """The reference's cases (tests/test_kernels.py::test_flow_accum_shapes)."""
    rng = np.random.default_rng(n * 17 + p)
    flow = rng.uniform(0, 5, (n, n)).astype(np.float32)
    cur, nxt, amt = _pairs(rng, p, n)
    want = np.asarray(ref_flow_accumulate(*map(jnp.asarray,
                                               (flow, cur, nxt, amt))))
    got = flow_accumulate(*map(torch.from_numpy, (flow, cur, nxt, amt)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_flow_accumulate_batched_and_sequential_order():
    """Batched [B, n, n] like the reference's test_flow_accum_batched, and
    bit-equal to adding the pairs one by one in ascending p (the order the
    CUDA kernel adds them in)."""
    rng = np.random.default_rng(3)
    B, n, p = 4, 20, 400
    flow = rng.uniform(0, 5, (B, n, n)).astype(np.float32)
    cur, nxt, amt = _pairs(rng, (B, p), n)
    want = np.asarray(ref_flow_accumulate(*map(jnp.asarray,
                                               (flow, cur, nxt, amt))))
    got = flow_accumulate(*map(torch.from_numpy, (flow, cur, nxt, amt)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    seq = flow.copy()
    for b in range(B):
        for k in range(p):
            seq[b, cur[b, k], nxt[b, k]] = np.float32(
                seq[b, cur[b, k], nxt[b, k]] + amt[b, k])
    np.testing.assert_array_equal(got.numpy(), seq)
    one = flow_accumulate(*(torch.from_numpy(x[2]) for x in (flow, cur, nxt,
                                                             amt)))
    assert torch.equal(one, got[2])


def test_flow_accumulate_duplicates_and_zero_amount():
    flow = torch.zeros((4, 4))
    cur = torch.tensor([1, 1, 1, 2], dtype=torch.int32)
    nxt = torch.tensor([2, 2, 2, 3], dtype=torch.int32)
    amt = torch.tensor([1.0, 2.0, 3.0, 4.0])
    got = flow_accumulate(flow, cur, nxt, amt)
    assert float(got[1, 2]) == 6.0 and float(got[2, 3]) == 4.0
    assert float(got.sum()) == 10.0
    base = torch.rand((16, 16))
    idx = torch.randint(0, 16, (200,), dtype=torch.int32)
    assert torch.equal(flow_accumulate(base, idx, idx.flip(0),
                                       torch.zeros(200)), base)
    assert torch.equal(flow_accumulate_ref(flow, cur, nxt, amt), got)


def _emulation_cases():
    """(name, flow, cur, nxt, amount, chunk) for the kernel's decomposition:
    duplicate cells, one row holding every pair, P not a multiple of the
    chunk, out-of-range pairs, B > 1."""
    rng = np.random.default_rng(41)
    cases = []
    n, P = 6, 300
    cur = rng.integers(0, 2, (1, P)).astype(np.int32)      # two rows
    nxt = rng.integers(0, 2, (1, P)).astype(np.int32)      # many duplicates
    cases.append(("duplicate_cells", 1, n, cur, nxt, 64))
    n, P = 33, 1000
    cur = np.full((1, P), 17, np.int32)                    # one row only
    nxt = rng.integers(0, n, (1, P)).astype(np.int32)
    cases.append(("one_row", 1, n, cur, nxt, 96))
    n, P = 20, 777                                         # 777 % 64 != 0
    cases.append(("ragged_chunks", 2, n,
                  rng.integers(0, n, (2, P)).astype(np.int32),
                  rng.integers(0, n, (2, P)).astype(np.int32), 64))
    n, P = 12, 500
    cur = rng.integers(-3, n + 3, (3, P)).astype(np.int32)  # out of range
    nxt = rng.integers(-3, n + 3, (3, P)).astype(np.int32)
    cases.append(("out_of_range", 3, n, cur, nxt, 32))
    n, P = 64, 64 * 64
    cases.append(("batch_default_chunk", 5, n,
                  rng.integers(0, n, (5, P)).astype(np.int32),
                  rng.integers(0, n, (5, P)).astype(np.int32), None))
    out = []
    for name, B, n, cur, nxt, chunk in cases:
        flow = rng.uniform(0, 5, (B, n, n)).astype(np.float32)
        amt = rng.uniform(0, 2, cur.shape).astype(np.float32)
        out.append(pytest.param(flow, cur, nxt, amt, chunk, id=name))
    return out


@pytest.mark.parametrize("flow,cur,nxt,amt,chunk", _emulation_cases())
def test_kernel_decomposition_bit_equal_to_index_add(flow, cur, nxt, amt,
                                                     chunk):
    """The CUDA kernels' decomposition (histogram, scan, stable ranks, the
    per-row walk), emulated in plain torch, is bit-equal to the CPU's
    ascending-p ``index_add_`` over the in-range pairs (the kernel drops a
    pair outside [0, n)), and within rtol 1e-6 / atol 1e-6 of the reference
    kernel in interpret mode; each design alone equals it in the batch."""
    n = flow.shape[-1]
    live = (cur >= 0) & (cur < n) & (nxt >= 0) & (nxt < n)
    t = [torch.from_numpy(x) for x in (flow, cur, nxt, amt)]
    got = fa.flow_accum_emulated(*t, chunk=chunk)
    kept = [torch.from_numpy(x) for x in (np.where(live, cur, 0),
                                          np.where(live, nxt, 0),
                                          np.where(live, amt, 0.0))]
    want = fa.flow_accum_plain(t[0], *kept)
    # a zero amount leaves a cell's bits alone, so the dropped pairs may
    # stand at (0, 0) with amount 0 in the plain scatter
    assert torch.equal(got, want)
    ref = np.asarray(ref_flow_accumulate(*map(jnp.asarray, (
        flow, *[k.numpy() for k in kept]))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    for b in range(flow.shape[0]):
        one = fa.flow_accum_emulated(*(x[b:b + 1] for x in t), chunk=chunk)
        assert torch.equal(one[0], got[b])


def test_pair_chunks_and_scratch_follow_the_pair_count():
    """At most 256 chunks a design, each a multiple of 32 pairs; the scratch
    holds the offsets and the sorted pairs; the walk's shared memory stays
    inside one block's limit well past the largest n the paths run."""
    for P in (0, 1, 511, 512, 65536, 131073, 3_000_000):
        c = fa.pair_chunk(P)
        assert c % 32 == 0 and c >= 512 and -(-P // c) <= fa.MAX_CHUNKS
    assert fa.scratch_ints(1, 256, 65536) == 256 * 128 + 1 + 2 * 65536
    assert fa.smem_bytes(256) == 4 * 288 * 4
    assert fa.smem_bytes(1720) <= fa.SMEM_MAX


def test_cuda_wrapper_refuses_cpu_tensors():
    flow = torch.zeros((1, 4, 4))
    idx = torch.zeros((1, 3), dtype=torch.int32)
    launches = fa.flow_accum_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flow_accum_cuda(flow, idx, idx, torch.zeros((1, 3)))
    flow_accumulate(flow, idx, idx, torch.ones((1, 3)))
    assert fa.flow_accum_cuda.launches == launches


_WALK_TOPOLOGIES = [t for t in TOPOLOGIES if t != "custom"]


@pytest.mark.parametrize("topology", _WALK_TOPOLOGIES)
def test_pair_walk_throughput_matches_reference(topology):
    """throughput_proxy(use_kernel=True) on every registry topology at 16
    chiplets, every argument passed positionally in the reference's order
    (next_hop, adj_bw, traffic, max_hops, use_kernel, directed, adaptive)."""
    ref_arrays, _ = ref_prepare_arrays(ref_make_design(topology, 16))
    arrays, _ = prepare_arrays(make_design(topology, 16))
    np.testing.assert_array_equal(arrays.next_hop, ref_arrays.next_hop)
    t = make_traffic("hotspot", 16, seed=2).astype(np.float32)
    np.testing.assert_array_equal(
        t, ref_make_traffic("hotspot", 16, seed=2).astype(np.float32))
    mh = ref_routed_diameter(ref_arrays.next_hop)
    nh, bw = arrays.next_hop, arrays.adj_bw
    for directed, adaptive in ((False, False), (True, True)):
        want = float(ref_throughput.throughput_proxy(
            jnp.asarray(nh), jnp.asarray(bw), jnp.asarray(t), mh, True,
            directed, adaptive))
        got = float(throughput.throughput_proxy(
            torch.from_numpy(nh), torch.from_numpy(bw), torch.from_numpy(t),
            mh, True, directed, adaptive))
        assert got == pytest.approx(want, rel=RTOL), (directed, adaptive)
        load = float(throughput.throughput_proxy(
            torch.from_numpy(nh), torch.from_numpy(bw), torch.from_numpy(t),
            mh, False, directed, adaptive))
        assert got == pytest.approx(load, rel=RTOL)


def test_positional_arguments_mean_the_same_in_both_packages():
    """The repaired fault: a call written for the reference, such as
    ``throughput_proxy(nh, bw, t, mh, False, True)``, means directed=True in
    both packages (it meant adaptive=True in the port before)."""
    arrays, _ = prepare_arrays(make_design("kite", 16))
    t = make_traffic("hotspot", 16, seed=1).astype(np.float32)
    nh, bw = arrays.next_hop, arrays.adj_bw
    mh = ref_routed_diameter(nh)
    tnh, tbw, tt = map(torch.from_numpy, (nh, bw, t))
    jnh, jbw, jt = map(jnp.asarray, (nh, bw, t))
    for args in ((mh, False, True), (mh, False, False, True),
                 (mh, True, True, False), (None, False, True, True)):
        want = float(ref_throughput.throughput_proxy(jnh, jbw, jt, *args))
        got = float(throughput.throughput_proxy(tnh, tbw, tt, *args))
        assert got == pytest.approx(want, rel=RTOL), args
    directed = float(throughput.throughput_proxy(tnh, tbw, tt, mh, False,
                                                 True))
    undirected = float(throughput.throughput_proxy(tnh, tbw, tt, mh, False,
                                                   False, True))
    assert directed != pytest.approx(undirected, rel=RTOL)
    for args in ((mh, False, True), (mh, True, False)):
        np.testing.assert_allclose(
            throughput.edge_flows(tnh, tt, *args).numpy(),
            np.asarray(ref_throughput.edge_flows(jnh, jt, *args)),
            rtol=RTOL, atol=1e-7)


def test_pair_walk_batched_and_unreachable_pairs():
    """A batch of two tables through the pair walk equals each alone; a
    table that cannot reach chiplet 5 piles the stranded traffic on the
    diagonal for exactly max_hops hops, as the load-propagation route does."""
    arrays, _ = prepare_arrays(make_design("mesh", 16))
    t = torch.from_numpy(make_traffic("random_uniform", 16).astype(np.float32))
    cut = arrays.next_hop.copy()
    cut[:, 5] = np.arange(16)
    cut[5, 5] = 5
    both = torch.from_numpy(np.stack([arrays.next_hop, cut]))
    mh = 8
    walk = throughput.edge_flows(both, t, mh, True)
    for b in range(2):
        assert torch.equal(walk[b], throughput.edge_flows(both[b], t, mh,
                                                          True))
    load = throughput.edge_flows(both, t.expand(2, 16, 16), mh)
    np.testing.assert_allclose(walk.numpy(), load.numpy(), rtol=RTOL,
                               atol=1e-7)
    assert float(torch.diagonal(walk[1]).sum()) > 0.0
