# Port of src/repro/analysis/registry.py: the reference's contracts, with
# their names and shapes, over the port's programs.
"""The audited-program registry: every performance-critical program of the
port, the representative bucket shapes it runs at, and its structural
contract (see :mod:`.graph_audit`).

The registry is also the source of the large-n variant plan
(``large_n_plan``): the dense and blocked forms audited here, and the
dense-coverage limit they are audited at.

Inputs are built inside the contract thunks from fixed seeds, on the
device the audit runs on — importing this module runs nothing. The port
has no backend knob: a CUDA tensor takes the kernel, a CPU tensor the plain
form, and the node count picks the dense or the slab form
(``REPRO_LOAD_PROP_FUSED_N``, ``REPRO_APSP_FUSED_N``,
``REPRO_ROUTING_BLOCK_N``), so each of the reference's backend trios is one
dense and one blocked contract here.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .graph_audit import SCATTER_OPS, Contract, record, record_numpy

# The bucket shape the dense ops contracts are audited at — and therefore
# the largest n at which the benchmark times the dense variants.
LARGE_N_DENSE_MAX = 256

# How far a card run may be from the CPU's plain forms: the min-plus
# programs (APSP, hop tables) give the same bits on every form; the float
# sums of load propagation and the proxies agree to f32 rounding.
EXACT = (0.0, 0.0)
F32_SUMS = (1e-5, 1e-6)


def _mesh_adjacency(n: int) -> np.ndarray:
    """[n, n] bool adjacency of a square 2D mesh of n nodes."""
    side = int(round(n ** 0.5))
    if side * side != n:
        raise ValueError(f"{n} is not a square")
    r, c = np.divmod(np.arange(n), side)
    return (np.abs(r[:, None] - r) + np.abs(c[:, None] - c)) == 1


def _mesh_next_hop(n: int) -> np.ndarray:
    """[n, n] int32 XY routing table of a square mesh (next_hop[u, d])."""
    side = int(round(n ** 0.5))
    r, c = np.divmod(np.arange(n), side)
    ru, cu, rd, cd = r[:, None], c[:, None], r[None, :], c[None, :]
    step_c = np.sign(cd - cu)
    step_r = np.where(step_c == 0, np.sign(rd - ru), 0)
    return ((ru + step_r) * side + cu + step_c).astype(np.int32)


def _load0(rng, batch: int, n: int) -> np.ndarray:
    """Dest-major traffic [batch, n, n] with a zero diagonal."""
    t = rng.random((batch, n, n)).astype(np.float32)
    t[:, np.arange(n), np.arange(n)] = 0.0
    return t


def _mesh_costs(rng, batch: int, n: int) -> np.ndarray:
    """[batch, n, n] step costs on a mesh's edges, +inf elsewhere."""
    adj = _mesh_adjacency(n)
    w = (1.0 + rng.random((batch, n, n))).astype(np.float32)
    w = np.minimum(w, w.transpose(0, 2, 1))
    return np.where(adj, w, np.inf).astype(np.float32)


def _on(dev, x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# kernels.ops: load_propagate / apsp, dense and blocked forms
# ---------------------------------------------------------------------------

def _trace_load_prop(dev, n: int, batch: int):
    from ..kernels import ops

    rng = np.random.default_rng(n + batch)
    nh = _on(dev, np.broadcast_to(_mesh_next_hop(n), (batch, n, n)).copy())
    l0 = _on(dev, _load0(rng, batch, n))
    return record(lambda a, b: ops.load_propagate(a, b), nh, l0)


def _trace_apsp(dev, n: int, batch: int):
    from ..kernels import ops

    d = _on(dev, _mesh_costs(np.random.default_rng(n + batch), batch, n))
    return record(ops.apsp, d)


# ---------------------------------------------------------------------------
# routing.device: batched next-hop construction, dense vs blocked
# ---------------------------------------------------------------------------

def _trace_lowest_id(dev, n: int, batch: int):
    from .. import core  # noqa: F401  (import order: core before routing)
    from ..kernels.ref import BIG
    from ..routing import device

    cost = _on(dev, _mesh_costs(np.random.default_rng(n), batch, n))
    cost = torch.where(torch.isfinite(cost), cost, BIG)
    dist = device.distances_batch(cost)
    relay = torch.ones((batch, n), dtype=torch.bool, device=dev)
    return record(device.lowest_id_next_hops_batch, cost, dist, relay)


def _trace_hops_next_hop(dev, n: int, batch: int):
    from .. import core  # noqa: F401  (import order: core before routing)
    from ..routing import device

    adj = _on(dev, np.broadcast_to(_mesh_adjacency(n), (batch, n, n)).copy())
    return record(device.hops_next_hop_batch, adj)


# ---------------------------------------------------------------------------
# dse.genomes: genome pipelines + population/node bucket ladders
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _adjacency_pipeline(n_chiplets: int, dev: torch.device):
    from .. import core  # noqa: F401  (import order: core before routing)
    from ..dse import genomes
    from ..opt.space import AdjacencySpace

    return genomes.AdjacencyPipeline(AdjacencySpace(n_chiplets=n_chiplets),
                                     dev)


def _trace_adjacency(dev, n_chiplets: int, pop: int):
    from ..dse import genomes

    pipe = _adjacency_pipeline(n_chiplets, dev)
    _, bits = pipe._bits(pipe.space.sample(np.random.default_rng(pop), pop))

    def run(b):
        return genomes._adjacency_eval(
            b, pipe._tables, n=pipe.n, k_phys=pipe.k_phys,
            euclid=pipe._euclid, max_hops=pipe.max_hops)

    return record(run, bits)


def _adjacency_ladder(dev, n_chiplets: int, pops=(5, 8, 9, 16, 17)):
    return [_trace_adjacency(dev, n_chiplets, p) for p in pops]


def _trace_adjacency_faults(dev, n_chiplets: int, pop: int, n_faults: int):
    from ..dse import genomes

    pipe = _adjacency_pipeline(n_chiplets, dev)
    rng = np.random.default_rng(pop * n_faults)
    _, bits = pipe._bits(pipe.space.sample(rng, pop))
    G = pipe.space.genome_length
    link_alive = rng.random((n_faults, G)) > 0.1
    link_alive[0] = True                       # the pristine scenario
    node_alive = np.ones((n_faults, n_chiplets), bool)
    node_alive[-1, n_chiplets // 2] = False    # one dead chiplet

    def run(b, la, na):
        return genomes._adjacency_eval_faults(
            b, la, na, pipe._tables, n=pipe.n, k_phys=pipe.k_phys,
            euclid=pipe._euclid, max_hops=pipe.max_hops)

    return record(run, bits, _on(dev, link_alive), _on(dev, node_alive))


def _line_structures(rng, n_raw: int, nb: int, pop: int):
    """``pop`` line designs of ``n_raw`` chiplets padded to ``nb`` nodes the
    way ``ParametricPipeline`` pads (self-looped, zero-traffic rows)."""
    ids = np.arange(nb)
    nh = np.tile(ids.astype(np.int16)[:, None], (1, nb))
    u, d = np.meshgrid(np.arange(n_raw), np.arange(n_raw), indexing="ij")
    nh[:n_raw, :n_raw] = np.where(d > u, u + 1, np.where(d < u, u - 1, u))
    adj = np.zeros((nb, nb), bool)
    adj[np.arange(n_raw - 1), np.arange(1, n_raw)] = True
    adj |= adj.T
    sc = np.where(adj, 1.0 + rng.random((pop, nb, nb)), 0.0)
    bw = np.where(adj, 8.0 + rng.random((pop, nb, nb)), 0.0)
    nw = np.zeros((pop, nb))
    nw[:, :n_raw] = 1.0
    tr = np.zeros((pop, nb, nb))
    tr[:, :n_raw, :n_raw] = rng.random((pop, n_raw, n_raw))
    tr[:, ids, ids] = 0.0
    f32 = np.float32
    return (np.broadcast_to(nh, (pop, nb, nb)).copy(), sc.astype(f32),
            nw.astype(f32), bw.astype(f32), tr.astype(f32))


def _trace_parametric(dev, n_raw: int, pop: int):
    from ..core.latency import num_doubling_steps
    from ..dse import genomes
    from ..dse.engine import batched_evaluate

    nb = genomes.node_bucket(n_raw)
    arrays = [_on(dev, x) for x in _line_structures(
        np.random.default_rng(n_raw), n_raw, nb, pop)]

    def run(*args):
        return batched_evaluate(*args, n_steps=num_doubling_steps(nb),
                                max_hops=max(nb - 1, 1))

    return record(run, *arrays)


def _parametric_ladder(dev, sizes=(9, 16, 17, 24, 33), pop: int = 8):
    return [_trace_parametric(dev, n, pop) for n in sizes]


# ---------------------------------------------------------------------------
# opt.space: the repair degree-cap scan (a host numpy loop in the port)
# ---------------------------------------------------------------------------

_REPAIR_N = 16      # n_chiplets: G = n(n-1)/2 = 120 gene pairs
_REPAIR_P = 12      # population — chosen != n so (P, n, n) is unambiguous


def _trace_repair_cap(dev, density: float):
    """``AdjacencySpace._degree_cap`` on a population dense enough that
    every run has over-cap vertices. The scan runs on the host whatever
    ``dev`` is."""
    from ..opt.space import AdjacencySpace

    space = AdjacencySpace(n_chiplets=_REPAIR_N)
    rng = np.random.default_rng(int(density * 100))
    bits = (rng.random((_REPAIR_P, space.genome_length))
            < density).astype(np.int64)
    return record_numpy(space._degree_cap, bits, space.degrees(bits),
                        function="_degree_cap", module="opt/space.py")


def _repair_ladder(dev, densities=(0.6, 0.65, 0.7, 0.75, 0.8, 0.9)):
    return [_trace_repair_cap(dev, p) for p in densities]


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def contracts() -> tuple[Contract, ...]:
    f32, i16 = torch.float32, torch.int16

    def lp(role, form, n, batch, **kw):
        return Contract(
            name=f"ops.load_propagate[{form},n={n},B={batch}]",
            description="load propagation + edge flows",
            trace=lambda dev: _trace_load_prop(dev, n, batch),
            forbidden_ops=SCATTER_OPS,
            forbid_f64=True,
            out_dtypes=(f32, f32),
            kernels=("load_prop_cuda",),
            parity=F32_SUMS,
            bench={"op": "load_propagate", "form": form, "role": role,
                   "n": n},
            **kw)

    def ap(role, form, n, batch, kernel, **kw):
        return Contract(
            name=f"ops.apsp[{form},n={n},B={batch}]",
            description="min-plus all-pairs path costs",
            trace=lambda dev: _trace_apsp(dev, n, batch),
            forbidden_ops=SCATTER_OPS,
            forbid_f64=True,
            out_dtypes=(f32,),
            kernels=(kernel,),
            parity=EXACT,
            bench={"op": "apsp", "form": form, "role": role, "n": n},
            **kw)

    return (
        # -- kernels.ops ----------------------------------------------------
        lp("dense", "dense", 64, 4),
        lp("blocked", "slab", LARGE_N_DENSE_MAX, 2,
           # tile slab [B, 128, n, n] = 2^24 elements exactly; the dense
           # one-hot would be [B, n, n, n] = 2^25 and must not fit
           max_transient_elements=1 << 24),
        ap("dense", "fused", 64, 4, "apsp_fused_cuda"),
        ap("blocked", "tiled", LARGE_N_DENSE_MAX, 2, "apsp_square_cuda",
           max_transient_elements=1 << 24),
        # -- routing.device -------------------------------------------------
        Contract(
            name="routing.lowest_id_next_hops[dense,n=64,B=2]",
            description="batched lowest-ID next-hop selection",
            trace=lambda dev: _trace_lowest_id(dev, 64, 2),
            forbidden_ops=SCATTER_OPS,
            forbid_f64=True,
            out_dtypes=(i16,),
            # its distances come from the APSP kernel on the card
            parity=EXACT),
        Contract(
            name="routing.lowest_id_next_hops[blocked,n=256,B=1]",
            description="destination-blocked next-hop selection",
            trace=lambda dev: _trace_lowest_id(dev, 256, 1),
            forbidden_ops=SCATTER_OPS,
            forbid_f64=True,
            out_dtypes=(i16,),
            # per-slab selection [B, n, tile, tile] = 2^22; the dense
            # [B, n, n, n] score tensor would be 2^24
            max_transient_elements=1 << 23,
            parity=EXACT),
        Contract(
            name="routing.hops_next_hop[dense,n=64,B=2]",
            description="BFS-by-matmul hop tables",
            trace=lambda dev: _trace_hops_next_hop(dev, 64, 2),
            forbidden_ops=SCATTER_OPS,
            forbid_f64=True,
            out_dtypes=(i16,),
            kernels=("minplus_cuda",),
            parity=EXACT),
        Contract(
            name="routing.hops_next_hop[blocked,n=256,B=1]",
            description="destination-blocked BFS hop tables",
            trace=lambda dev: _trace_hops_next_hop(dev, 256, 1),
            forbidden_ops=SCATTER_OPS,
            forbid_f64=True,
            out_dtypes=(i16,),
            max_transient_elements=1 << 23,
            kernels=("minplus_cuda",),
            parity=EXACT),
        # -- dse.genomes ----------------------------------------------------
        Contract(
            name="dse.genomes.adjacency[n=16]",
            description="adjacency genome eval (scatter-free)",
            trace=lambda dev: _trace_adjacency(dev, 16, 16),
            forbidden_ops=SCATTER_OPS,
            forbid_f64=True,
            gather_index_min_bits=32,
            ladder=lambda dev: _adjacency_ladder(dev, 16),
            # pops (5, 8, 9, 16, 17) bucket to {8, 16, 32}
            ladder_expected=3,
            kernels=("load_prop_cuda", "minplus_cuda"),
            parity=F32_SUMS),
        Contract(
            name="dse.genomes.adjacency_faults[n=16,P=8,F=4]",
            description="[P, F] population x fault grid (scatter-free; "
                        "flat [P*F] gathers, never a [P, F, n, n] "
                        "transient)",
            trace=lambda dev: _trace_adjacency_faults(dev, 16, 8, 4),
            forbidden_ops=SCATTER_OPS,
            forbid_f64=True,
            gather_index_min_bits=32,
            out_dtypes=(f32, f32, f32, f32),
            dims={"P": 8, "F": 4, "n": 16},
            forbidden_shapes=(("P", "F", "n", "n"),),
            kernels=("load_prop_cuda", "minplus_cuda"),
            parity=F32_SUMS),
        Contract(
            name="dse.genomes.parametric[n<=48]",
            description="structure-table parametric eval (int16 tables)",
            trace=lambda dev: _trace_parametric(dev, 16, 8),
            forbidden_ops=SCATTER_OPS,
            forbid_f64=True,
            gather_index_min_bits=32,
            ladder=lambda dev: _parametric_ladder(dev),
            # node counts (9, 16, 17, 24, 33) bucket to {16, 32, 48}
            ladder_expected=3,
            kernels=("load_prop_cuda",),
            parity=F32_SUMS),
        # -- opt.space ------------------------------------------------------
        Contract(
            name="opt.space.repair_cap[n=16,P=12]",
            description="degree-cap scan of AdjacencySpace.repair (a host "
                        "numpy loop: one program at every candidate count)",
            trace=lambda dev: _trace_repair_cap(dev, 0.7),
            dims={"P": _REPAIR_P, "n": _REPAIR_N},
            forbidden_shapes=(("P", "n", "n"), ("n", "n", "P"),
                              ("n", "P", "n")),
            ladder=lambda dev: _repair_ladder(dev),
            # no candidate bucket and nothing compiled: the scan's arrays
            # are [P, G], [P, n], [G] and [P] whatever the candidate count
            ladder_expected=1),
    )


def large_n_plan() -> dict:
    """Variant plan derived from the registry: op -> the dense and blocked
    forms audited above, plus the dense n ceiling."""
    plan: dict[str, dict] = {}
    for c in contracts():
        if not c.bench:
            continue
        op = c.bench["op"]
        entry = plan.setdefault(op, {"dense_max_n": LARGE_N_DENSE_MAX})
        role = c.bench["role"]
        if role in ("dense", "blocked"):
            entry[role] = c.bench["form"]
    return plan


__all__ = ["contracts", "large_n_plan", "LARGE_N_DENSE_MAX"]
