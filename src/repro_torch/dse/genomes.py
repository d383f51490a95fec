"""Genome -> metrics pipelines: the optimizer's cost function. Port of
``src/repro/dse/genomes.py``.

* ``AdjacencyPipeline`` — from a bit-genome population of
  ``opt.space.AdjacencySpace`` to (latency, throughput) on the device: the
  genome decode (bits -> adjacency), chiplet geometry (grid placement,
  greedy nearest-PHY assignment, link lengths, latencies, bandwidths), the
  routing tables (``routing.device.hops_next_hop_batch``: BFS matmuls and
  the min-plus kernel) and both proxies from one load propagation (the
  load-propagation kernel). Everything data-independent (chiplet sides, PHY
  offsets, bump-limited bandwidths per (radix, degree)) is a small host
  table computed in float64, indexed by the design's radix.
  ``evaluate_faults_async`` evaluates a population under a batch of fault
  scenarios as one flat [P*F] grid of degraded designs through the same
  routing tables and load propagation.
* ``ParametricPipeline`` — ``opt.space.ParametricSpace`` genomes index a
  finite set of structures: they are built lazily on the host through the
  shared structure cache, stacked, and each population is one gather plus
  the sweep engine's batched proxies.

Both pipelines shard the population over a list of devices, the port's
counterpart of the reference's ``shard_map`` over the mesh's ``"data"``
axis: the padded population is cut into equal contiguous shards, each shard
is dispatched on its own device (in shard order, from one host thread) and
the results are collected in shard order. The tables are replicated once
per distinct device, and there is no communication between shards. Each
shard runs its own adaptive loops, so each stops at its own routed
diameter. The list may repeat a device (``["cpu"] * 4``, ``["cuda:0"] *
4``), as XLA's forced host device count repeats the host.

PyTorch runs eagerly, so there are no compiled programs to cache; the
population is still padded to the reference's power-of-two buckets rounded
up to a multiple of the shard count (``bucket_population``) and node counts
to ``node_bucket``, so the port evaluates the same shapes. Every reduction
over a design runs in an order fixed by the design's own shape
(``core.latency.pairwise_sum``, min, the kernels), so a genome gives the
same bits alone as in any population, and k shards the same bits as one.

Reports (area, power, cost for the constraint masks) stay on the host in
float64, exact against ``core.reports``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..core.latency import num_doubling_steps, pairwise_sum
from ..core.reports import ReportArrays
from ..kernels.ops import load_propagate
from ..kernels.ref import BIG
from ..obs.trace import span as _span
from ..routing.device import hops_next_hop_batch
from ..utils.device import (gather_rows, on_device, resolve_devices,
                            shard_rows)
from .engine import batched_evaluate


def bucket_population(size: int, multiple: int = 1) -> int:
    """Pad the population axis to a power-of-two bucket (>= 8) rounded up to
    a device-count multiple (the reference's shapes)."""
    b = 1 << max(3, int(size - 1).bit_length())
    if multiple > 1:
        b = ((b + multiple - 1) // multiple) * multiple
    return b


NODE_TILE = 16


def node_bucket(n: int) -> int:
    """Pad node counts to ``NODE_TILE``-multiple buckets (floor 8), as the
    reference does: padding rows are self-looped routers with zero traffic,
    exact no-ops for every proxy."""
    if n <= 8:
        return 8
    return ((n + NODE_TILE - 1) // NODE_TILE) * NODE_TILE


class PendingGenomeEval:
    """Handle for an evaluation whose device work may still be running.
    ``result()`` waits on the CUDA event recorded after each shard's last
    launch, then collects the shards and builds the host-side reports; it
    is idempotent."""

    def __init__(self, finisher, events: list | None = None):
        self._finisher = finisher
        self._events = events or []
        self._result: GenomeEvalResult | None = None

    def result(self) -> "GenomeEvalResult":
        if self._finisher is not None:
            for event in self._events:
                event.synchronize()
            self._result = self._finisher()
            self._finisher = None
        return self._result


@dataclass
class GenomeEvalResult:
    """Metrics for one genome population (see DseEngine.evaluate_genomes)."""
    latency: np.ndarray       # [P] f32
    throughput: np.ndarray    # [P] f32
    reports: ReportArrays     # [P] f64 host-exact constraint columns


@dataclass
class FaultGridResult:
    """Degraded metrics over a [P, F] population x fault-scenario grid:
    every genome evaluated under every fault scenario in one batch;
    ``faults.objectives`` reduces the grid into robust Pareto
    objectives."""
    latency: np.ndarray              # [P, F] f32 (BIG when nothing routes)
    throughput: np.ndarray           # [P, F] f32 (0 when nothing routes)
    reachable_fraction: np.ndarray   # [P, F] f32 delivered traffic share
    reports: ReportArrays            # [P] pristine constraint columns


def _pending(devices: list[torch.device], finisher) -> PendingGenomeEval:
    """One CUDA event per shard, recorded on its device's current stream
    after the shard's launches."""
    events = []
    for dev in devices:
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            events.append(event)
    return PendingGenomeEval(finisher, events)


# ---------------------------------------------------------------------------
# AdjacencySpace: bits -> metrics
# ---------------------------------------------------------------------------

def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Fixed-order sum over the last dim (``pairwise_sum`` over [.., 1, m])."""
    return pairwise_sum(x.unsqueeze(-2))


def _eval_proxies(next_hop, step_cost, node_weight, adj_bw, traffic,
                  max_hops: int):
    """Both proxies from ONE load propagation (``kernels.ops.
    load_propagate``): the accumulated per-destination load W[d, u] gives
    the edge flows through the primitive's final contraction, and, because
    a unit of traffic pays step_cost(u, nh[u, d]) each time it leaves u,
    the traffic-weighted total path cost is

        Σ_{u,d} W[d, u] · step_cost[u, nh[u, d]] + Σ_d (Σ_s T[s, d]) · nw[d]

    Exact for connected (repaired) designs. Every sum is ``pairwise_sum``,
    whose order is fixed by the matrix size."""
    Pn, n, _ = next_hop.shape
    t32 = traffic.to(torch.float32)
    t_total = pairwise_sum(t32)
    dest_weight = _sum_last(_sum_last(t32.transpose(0, 1)) * node_weight)
    load0 = t32.transpose(0, 1)[None].expand(Pn, n, n)
    total, flow = load_propagate(next_hop, load0, max_hops=max_hops,
                                 adaptive=True)
    f = flow + flow.transpose(-1, -2)
    ratio = torch.where(f > 0, adj_bw / torch.clamp_min(f, 1e-30), torch.inf)
    thr = (ratio.amin(dim=(1, 2)) * t_total).to(torch.float32)
    sc_next = torch.gather(step_cost, 2, next_hop.long())       # [P, u, d]
    lat = ((pairwise_sum(total * sc_next.transpose(-1, -2)) + dest_weight)
           / t_total).to(torch.float32)
    return lat, thr


def _eval_proxies_masked(next_hop, step_cost, node_weight, adj_bw, traffic,
                         alive, max_hops: int):
    """``_eval_proxies`` generalized to degraded structures: only traffic
    between *reachable* alive pairs enters the books, and unreachable
    traffic becomes an explicit reachable-fraction output instead of
    inf-poisoning the proxies.

    next_hop/step_cost/adj_bw: [B, n, n] degraded structures (src-major
    tables; unreachable pairs self-loop); alive: [B, n] node-alive mask;
    traffic: [n, n] shared. Returns (latency, throughput,
    reachable_fraction) each [B] f32 — latency/throughput of the
    *delivered* traffic (BIG / 0.0 when nothing routes), and the delivered
    fraction of total offered traffic. Every sum is ``_eval_proxies``' in
    the same order, so an undamaged, connected design gets the same bits
    as from ``_eval_proxies``."""
    B, n, _ = next_hop.shape
    t32 = traffic.to(torch.float32)
    ids = torch.arange(n, device=next_hop.device)
    eye = ids[:, None] == ids[None, :]
    # next_hop[b, u, d] = u marks "no route": the ids index u, dim 1
    reach = (next_hop != ids[None, :, None]) | eye[None]
    deliver = reach & alive[:, :, None] & alive[:, None, :]
    t_m = torch.where(deliver, t32[None], 0.0)             # [B, n, n] src-major
    t_tot = pairwise_sum(t_m)                              # [B]
    dest_weight = _sum_last(_sum_last(t_m.transpose(-1, -2)) * node_weight)
    total, flow = load_propagate(next_hop, t_m.transpose(-1, -2),
                                 max_hops=max_hops, adaptive=True)
    f = flow + flow.transpose(-1, -2)
    ratio = torch.where(f > 0, adj_bw / torch.clamp_min(f, 1e-30), torch.inf)
    min_ratio = ratio.amin(dim=(1, 2))
    sc_next = torch.gather(step_cost, 2, next_hop.long())       # [B, u, d]
    path_cost = pairwise_sum(total * sc_next.transpose(-1, -2))
    routed = t_tot > 0
    lat = torch.where(routed, (path_cost + dest_weight)
                      / torch.clamp_min(t_tot, 1e-30), BIG).to(torch.float32)
    thr = torch.where(routed, min_ratio * t_tot, 0.0).to(torch.float32)
    reach_frac = (t_tot / torch.clamp_min(pairwise_sum(t32), 1e-30)
                  ).to(torch.float32)
    return lat, thr, reach_frac


def _phy_scan(bits_pad, deg, radix, pitch, t, *, n: int, k_phys: int):
    """Greedy nearest-PHY assignment: the PHY each set link takes at its two
    ends, [P, G] each (``u`` end, ``v`` end). The pick is the lowest PHY
    index within a relative tolerance of the nearest free one (the host's
    PHY_TIE_TOL rule).

    The used-set is per chiplet, so the host's sequential pass decomposes
    into n independent chains: chiplet c walks its n - 1 incident slots in
    the greedy order restricted to c. Only SET bits occupy a PHY, so each
    chain has at most k_phys real steps, and the scan runs over k_phys
    compacted steps (set slots first, relative order kept), one Python step
    each."""
    Pn = bits_pad.shape[0]
    G = bits_pad.shape[1] - 1
    dev = bits_pad.device
    pair_u, pair_v, col, row = t["pair_u"], t["pair_v"], t["col"], t["row"]
    coffx, coffy = t["cphyx"][radix], t["cphyy"][radix]   # phy - side/2
    phy_ids = torch.arange(k_phys, device=dev)
    phy_valid = phy_ids[None, :] < radix[:, None]               # [P, K]
    tie_tol = 1e-4
    dcol2 = torch.cat([col[pair_u] - col[pair_v], col[pair_v] - col[pair_u]])
    drow2 = torch.cat([row[pair_u] - row[pair_v], row[pair_v] - row[pair_u]])

    def cand_dist(es):
        """Candidate distances [P, n, K] of one compact step's endpoint
        slots, |Δcol·pitch + (phy.x - side/2)| + |Δrow·pitch + (phy.y -
        side/2)|."""
        dc = dcol2[es]                                          # [P, n]
        dr = drow2[es]
        return (torch.abs(dc[:, :, None] * pitch[:, None, None]
                          + coffx[:, None, :])
                + torch.abs(dr[:, :, None] * pitch[:, None, None]
                            + coffy[:, None, :]))

    # Chain compaction: the t-th set slot of chiplet c's chain goes to
    # compact step t. With rank_inc[j] = set slots through chain step j,
    # the t-th set slot sits at position Σ_j [rank_inc[j] <= t]; steps past
    # a chiplet's degree clamp to the last chain slot and are gated off.
    csb = bits_pad[:, t["chain_slot"]].to(torch.int64)          # [P, n-1, n]
    rank = torch.cumsum(csb, dim=1) - csb       # set slots before step j
    rank_inc = rank + csb
    pos = torch.stack([(rank_inc <= s).sum(dim=1) for s in range(k_phys)],
                      dim=1)                                    # [P, K, n]
    pos = torch.clamp_max(pos, t["chain_eslot"].shape[0] - 1)
    eslots = t["chain_eslot"][pos, torch.arange(n, device=dev)]  # [P, K, n]
    valid = phy_ids[None, :, None] < deg[:, None, :]            # [P, K, n]

    used = torch.zeros((Pn, n, k_phys), dtype=torch.bool, device=dev)
    picks = []
    for s in range(k_phys):
        d = cand_dist(eslots[:, s])                             # [P, n, K]
        free = phy_valid[:, None, :] & ~used
        d = torch.where(free, d, BIG)
        dm = d.amin(dim=2)
        near = d <= (dm + tie_tol * torch.clamp_min(dm, 1.0))[:, :, None]
        pick = torch.argmax((free & near).to(torch.uint8), dim=2)  # first
        used = used | ((phy_ids[None, None, :] == pick[:, :, None])
                       & valid[:, s, :, None])
        picks.append(pick)
    # per (pair, endpoint) picks [P, 2G]: a set slot's compact step is its
    # rank at its static (chain step, chiplet) coordinates
    picks_c = torch.stack(picks, dim=1)                         # [P, K, n]
    inv_j, inv_c = t["inv_j"], t["inv_c"]
    t_ge = torch.clamp_max(rank[:, inv_j, inv_c], k_phys - 1)   # [P, 2G]
    picks_ge = torch.gather(picks_c[:, :, inv_c], 1, t_ge[:, None, :])[:, 0]
    return picks_ge[:, :G], picks_ge[:, G:]


def _decode(bits, t, *, k_phys: int):
    """Genome decode: repaired bit genomes [P, G] -> (bits as bool, bits
    padded with one False column, adjacency [P, n, n], degrees [P, n],
    radix [P], pitch [P])."""
    Pn = bits.shape[0]
    bitsb = bits.to(torch.bool)
    bits_pad = torch.cat([bitsb, torch.zeros((Pn, 1), dtype=torch.bool,
                                             device=bits.device)], dim=1)
    adj = bits_pad[:, t["pair_id"]]                             # [P, n, n]
    deg = adj.sum(dim=2, dtype=torch.int64)                     # [P, n]
    radix = torch.clamp(deg.amax(dim=1), 1, k_phys)             # [P]
    pitch = t["side"][radix] + t["consts"][0]
    return bitsb, bits_pad, adj, deg, radix, pitch


def _link_geometry(bitsb, adj, deg, radix, pitch, pick_u, pick_v, t, *,
                   euclid: bool):
    """Link geometry from the decode and the PHY picks -> structure tensors
    ``(adj, step_cost, adj_bw, length)``, link latencies and bandwidths in
    pair order."""
    Pn = bitsb.shape[0]
    dev = bitsb.device
    _, link_const, link_per_mm, phy_lat2, internal = t["consts"]
    pair_u, pair_v, pair_id = t["pair_u"], t["pair_v"], t["pair_id"]
    col, row = t["col"], t["row"]
    offx, offy = t["phyx"][radix], t["phyy"][radix]             # [P, K]
    ax = col[pair_u][None, :] * pitch[:, None] + torch.gather(offx, 1, pick_u)
    ay = row[pair_u][None, :] * pitch[:, None] + torch.gather(offy, 1, pick_u)
    bx = col[pair_v][None, :] * pitch[:, None] + torch.gather(offx, 1, pick_v)
    by = row[pair_v][None, :] * pitch[:, None] + torch.gather(offy, 1, pick_v)
    if euclid:
        length = torch.sqrt((ax - bx) ** 2 + (ay - by) ** 2)
    else:
        length = torch.abs(ax - bx) + torch.abs(ay - by)
    lat = link_const + link_per_mm * length + phy_lat2
    bw_t = t["bw"]
    bw = torch.minimum(bw_t[radix[:, None], deg[:, pair_u]],
                       bw_t[radix[:, None], deg[:, pair_v]])

    lat_pad = torch.cat([torch.where(bitsb, lat, BIG),
                         torch.full((Pn, 1), BIG, device=dev)], dim=1)
    bw_pad = torch.cat([torch.where(bitsb, bw, 0.0),
                        torch.zeros((Pn, 1), device=dev)], dim=1)
    adj_bw = bw_pad[:, pair_id]
    step_cost = torch.where(adj, internal + lat_pad[:, pair_id], 0.0)
    return adj, step_cost, adj_bw, length


def _adjacency_structure(bits, t, *, n: int, k_phys: int, euclid: bool):
    """Genome decode + geometry: repaired bit genomes [P, G] -> structure
    tensors ``(adj, step_cost, adj_bw, length)``. ``t`` holds the
    pipeline's device tables (see ``AdjacencyPipeline``). Three stages,
    each timed on its own by ``chip_smoke.py``: ``_decode``, ``_phy_scan``
    and ``_link_geometry``."""
    bitsb, bits_pad, adj, deg, radix, pitch = _decode(bits, t, k_phys=k_phys)
    pick_u, pick_v = _phy_scan(bits_pad, deg, radix, pitch, t, n=n,
                               k_phys=k_phys)
    return _link_geometry(bitsb, adj, deg, radix, pitch, pick_u, pick_v, t,
                          euclid=euclid)


def _adjacency_eval(bits, t, *, n: int, k_phys: int, euclid: bool,
                    max_hops: int):
    """Repaired bit genomes [P, G] -> per-design latency, throughput and
    summed link length: decode and geometry, the routing tables (hops
    metric, every chiplet relays), and the two proxies."""
    adj, step_cost, adj_bw, length = _adjacency_structure(
        bits, t, n=n, k_phys=k_phys, euclid=euclid)
    next_hop = hops_next_hop_batch(adj)
    node_weight = t["consts"][4].expand(n)        # the chiplets' internal latency
    lat, thr = _eval_proxies(next_hop, step_cost, node_weight, adj_bw,
                             t["traffic"], max_hops)
    len_sum = _sum_last(torch.where(bits.to(torch.bool), length, 0.0))
    return lat, thr, len_sum


def _adjacency_eval_faults(bits, link_alive, node_alive, t, *, n: int,
                           k_phys: int, euclid: bool, max_hops: int):
    """The [P, F] population x fault grid: every genome evaluated under
    every fault scenario in one batch.

    bits: [P, G] repaired genomes; link_alive: [F, G] per-scenario link
    survival (False = failed); node_alive: [F, n] chiplet survival. The
    pristine structure (geometry, PHY assignment, bandwidths) is built once
    per genome via ``_adjacency_structure``; each scenario then masks the
    adjacency — dead links vanish, dead chiplets lose all incident links
    and stop sourcing/sinking traffic — and the degraded routing tables are
    recomputed under the mask by the same batched BFS
    (``routing.device.hops_next_hop_batch``) over a flat [P*F] batch: row
    p*F + f of the grid is genome p under scenario f, made by integer
    gathers, never as a [P, F, n, n] transient. Returns (latency,
    throughput, reachable_fraction) each [P, F] f32 plus the pristine
    summed link length [P]."""
    Pn = bits.shape[0]
    F = link_alive.shape[0]
    dev = bits.device
    adj, step_cost, adj_bw, length = _adjacency_structure(
        bits, t, n=n, k_phys=k_phys, euclid=euclid)
    # scenario masks in pair space: pad column G (the diagonal) stays alive
    # — adj is already False there
    alive_pad = torch.cat([link_alive.to(torch.bool),
                           torch.ones((F, 1), dtype=torch.bool, device=dev)],
                          dim=1)
    alive_pairs = alive_pad[:, t["pair_id"]]                    # [F, n, n]
    node_ok = node_alive.to(torch.bool)                         # [F, n]
    i = torch.arange(Pn * F, device=dev)
    p_idx, f_idx = i // F, i % F
    ok_f = node_ok[f_idx]                                       # [P*F, n]
    adj_pf = (adj[p_idx] & alive_pairs[f_idx] & ok_f[:, :, None]
              & ok_f[:, None, :])
    step_pf = torch.where(adj_pf, step_cost[p_idx], 0.0)
    bw_pf = adj_bw[p_idx]          # dead links carry zero flow -> unused
    next_hop = hops_next_hop_batch(adj_pf)
    node_weight = t["consts"][4].expand(n)
    lat, thr, reach = _eval_proxies_masked(next_hop, step_pf, node_weight,
                                           bw_pf, t["traffic"], ok_f,
                                           max_hops)
    len_sum = _sum_last(torch.where(bits.to(torch.bool), length, 0.0))
    return (lat.reshape(Pn, F), thr.reshape(Pn, F), reach.reshape(Pn, F),
            len_sum)


class AdjacencyPipeline:
    """Device path for ``opt.space.AdjacencySpace`` populations, sharded
    over ``devices`` (one device or a sequence, repeats allowed)."""

    def __init__(self, space, devices):
        from ..core.graph import link_bandwidth
        from ..core.reports import _interposer_tech_default as _itech
        from ..core.reports import die_cost
        from ..topologies.factory import grid_placement, make_chiplet
        from ..topologies.grid import grid_dims
        from ..traffic import make_traffic

        if space.routing != "dijkstra_lowest_id":
            raise ValueError(
                f"device path supports dijkstra_lowest_id routing only "
                f"(space routing: {space.routing!r}); use the host path")
        self.space = space
        self.devices = resolve_devices(devices)
        self.device = self.devices[0]
        n = space.n_chiplets
        self.n = n
        pkg = space.packaging
        # Repair's soft cap: connectivity joins may exceed max_degree by one.
        self.k_phys = max(min(n - 1, space.max_degree + 1), 1)
        K = self.k_phys

        # Per-radix host tables (float64 geometry, cast once for the device).
        side = np.zeros(K + 1, np.float64)
        phyx, phyy, cphyx, cphyy = (np.zeros((K + 1, K), np.float64)
                                    for _ in range(4))
        bw = np.zeros((K + 1, K + 2), np.float64)
        chip_area = np.zeros(K + 1, np.float64)
        chip_power = np.zeros(K + 1, np.float64)
        ia = np.zeros(K + 1, np.float64)
        cost_col = np.zeros(K + 1, np.float64)
        tech = space.technology

        class _D:  # the one field _interposer_tech_default reads
            technologies = (tech,)

        itech = _itech(_D)
        for r in range(1, K + 1):
            ct = make_chiplet(r)
            side[r] = ct.width
            for pi, phy in enumerate(ct.phys):
                phyx[r, pi] = phy.x
                phyy[r, pi] = phy.y
                cphyx[r, pi] = phy.x - ct.width / 2
                cphyy[r, pi] = phy.y - ct.height / 2
            for d in range(1, K + 2):
                bw[r, d] = link_bandwidth(ct.area, ct.bump_area_fraction, d,
                                          pkg.bump_pitch, pkg.non_data_wires)
            chip_area[r] = ct.area
            chip_power[r] = ct.power
            pos = grid_placement(n, ct.width, 1.0)
            x1 = max(px for px, py in pos) + ct.width
            y1 = max(py for px, py in pos) + ct.width
            ia[r] = x1 * y1
            cost_col[r] = (n * die_cost(ct.area, tech) + die_cost(ia[r], itech)
                           + pkg.packaging_cost_base
                           + pkg.packaging_cost_per_mm2 * ia[r])
        self._chip_area = chip_area
        self._chip_power = chip_power
        self._ia = ia
        self._cost = cost_col

        rows, cols = grid_dims(n)
        col_of = np.arange(n) % cols
        row_of = np.arange(n) // cols
        pu, pv = space.pair_u, space.pair_v
        G = len(pu)
        gridd = (np.abs(col_of[pu] - col_of[pv])
                 + np.abs(row_of[pu] - row_of[pv]))
        order = np.lexsort((np.arange(G), gridd)).astype(np.int64)
        # chain step j, chiplet c -> genome slot / (slot, endpoint) index,
        # and each (slot, endpoint)'s (chain step, chiplet) coordinates
        chain_slot = np.zeros((n - 1, n), np.int64)
        chain_eslot = np.zeros((n - 1, n), np.int64)
        inv_j = np.zeros(2 * G, np.int64)
        inv_c = np.zeros(2 * G, np.int64)
        cnt = np.zeros(n, np.int64)
        for g in order:
            for endpoint, c in ((0, pu[g]), (1, pv[g])):
                j = cnt[c]
                cnt[c] += 1
                chain_slot[j, c] = g
                chain_eslot[j, c] = g + endpoint * G
                inv_j[endpoint * G + g] = j
                inv_c[endpoint * G + g] = c
        assert (cnt == n - 1).all()
        pair_id = np.full((n, n), G, np.int64)
        pair_id[pu, pv] = np.arange(G)
        pair_id[pv, pu] = np.arange(G)
        traffic = make_traffic(space.traffic_pattern, n, seed=space.seed)

        i64, f32 = torch.int64, torch.float32
        host = {
            "pair_u": (pu, i64), "pair_v": (pv, i64),
            "pair_id": (pair_id, i64), "chain_slot": (chain_slot, i64),
            "chain_eslot": (chain_eslot, i64), "inv_j": (inv_j, i64),
            "inv_c": (inv_c, i64), "col": (col_of, f32),
            "row": (row_of, f32), "side": (side, f32),
            "phyx": (phyx, f32), "phyy": (phyy, f32),
            "cphyx": (cphyx, f32), "cphyy": (cphyy, f32),
            "bw": (bw, f32), "traffic": (traffic, f32),
            "consts": ([1.0, pkg.link_latency_const,
                        pkg.link_latency_per_mm,
                        2.0 * make_chiplet(1).phy_latency,
                        make_chiplet(1).internal_latency], f32),
        }
        # replicated once per distinct device, not once per shard
        self._tables_on = {
            dev: {k: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
                  for k, (x, dt) in host.items()}
            for dev in dict.fromkeys(self.devices)}
        self._tables = self._tables_on[self.device]
        self._euclid = pkg.link_routing == "euclidean"
        self.max_hops = max(n - 1, 1)

    def _bits(self, genomes: np.ndarray
              ) -> tuple[np.ndarray, list[torch.Tensor]]:
        """Degrees [P, n] of a repaired population (checked against the
        PHY bound) and its bits, padded to the population bucket (a
        multiple of the shard count) with copies of the last genome and cut
        into one shard per device."""
        deg = self.space.degrees(genomes)
        if deg.max(initial=0) > self.k_phys:
            raise ValueError(
                f"genome exceeds the repaired degree bound "
                f"({int(deg.max())} > {self.k_phys}); repair genomes "
                f"before evaluate_genomes")
        Pn = len(genomes)
        bp = bucket_population(Pn, len(self.devices))
        padded = genomes
        if bp != Pn:
            padded = np.concatenate(
                [genomes, np.repeat(genomes[-1:], bp - Pn, axis=0)], axis=0)
        return deg, shard_rows(padded % 2, self.devices, torch.int32)

    def evaluate_async(self, genomes: np.ndarray) -> PendingGenomeEval:
        """Launch the whole population's evaluation and return without
        waiting for the device; ``result()`` waits and adds the host
        reports."""
        genomes = np.asarray(genomes, np.int64)
        Pn = len(genomes)
        with _span("genomes.dispatch", space="adjacency", pop=Pn, n=self.n,
                   shards=len(self.devices)):
            deg, bits = self._bits(genomes)
            outs = []
            for dev, b in zip(self.devices, bits):
                with on_device(dev), torch.no_grad():
                    outs.append(_adjacency_eval(
                        b, self._tables_on[dev], n=self.n,
                        k_phys=self.k_phys, euclid=self._euclid,
                        max_hops=self.max_hops))
        lat, thr, len_sum = zip(*outs)

        def finish() -> GenomeEvalResult:
            with _span("genomes.finish", space="adjacency", pop=Pn):
                reports = self._report_arrays(genomes, deg,
                                              gather_rows(len_sum, Pn))
                return GenomeEvalResult(latency=gather_rows(lat, Pn),
                                        throughput=gather_rows(thr, Pn),
                                        reports=reports)

        return _pending(self.devices, finish)

    def evaluate(self, genomes: np.ndarray) -> GenomeEvalResult:
        """Blocking wrapper over ``evaluate_async``."""
        return self.evaluate_async(genomes).result()

    def evaluate_faults_async(self, genomes: np.ndarray,
                              link_fail: np.ndarray,
                              node_fail: np.ndarray) -> PendingGenomeEval:
        """Launch the [P, F] population x fault grid without waiting for
        the device. link_fail: [F, G] bool (True = link failed); node_fail:
        [F, n] bool (True = chiplet dead). ``result()`` returns a
        ``FaultGridResult``; pristine reports are computed on the host as
        in ``evaluate_async`` (faults are runtime events — the design is
        still manufactured with every link)."""
        genomes = np.asarray(genomes, np.int64)
        link_fail = np.atleast_2d(np.asarray(link_fail, bool))
        node_fail = np.atleast_2d(np.asarray(node_fail, bool))
        Pn = len(genomes)
        F = len(link_fail)
        if link_fail.shape[1] != self.space.genome_length:
            raise ValueError(
                f"link_fail has {link_fail.shape[1]} link slots; space "
                f"has {self.space.genome_length}")
        if node_fail.shape != (F, self.n):
            raise ValueError(
                f"node_fail shape {node_fail.shape} != ({F}, {self.n})")
        with _span("genomes.dispatch_faults", space="adjacency", pop=Pn,
                   n=self.n, faults=F, shards=len(self.devices)):
            deg, bits = self._bits(genomes)
            # the fault masks, replicated to every device
            masks = {dev: (torch.as_tensor(~link_fail, device=dev),
                           torch.as_tensor(~node_fail, device=dev))
                     for dev in dict.fromkeys(self.devices)}
            outs = []
            for dev, b in zip(self.devices, bits):
                with on_device(dev), torch.no_grad():
                    outs.append(_adjacency_eval_faults(
                        b, *masks[dev], self._tables_on[dev], n=self.n,
                        k_phys=self.k_phys, euclid=self._euclid,
                        max_hops=self.max_hops))
        lat, thr, reach, len_sum = zip(*outs)

        def finish() -> FaultGridResult:
            with _span("genomes.finish_faults", space="adjacency", pop=Pn):
                reports = self._report_arrays(genomes, deg,
                                              gather_rows(len_sum, Pn))
                return FaultGridResult(
                    latency=gather_rows(lat, Pn),
                    throughput=gather_rows(thr, Pn),
                    reachable_fraction=gather_rows(reach, Pn),
                    reports=reports)

        return _pending(self.devices, finish)

    def evaluate_faults(self, genomes: np.ndarray, link_fail: np.ndarray,
                        node_fail: np.ndarray) -> FaultGridResult:
        """Blocking wrapper over ``evaluate_faults_async``."""
        return self.evaluate_faults_async(genomes, link_fail,
                                          node_fail).result()

    def _report_arrays(self, genomes, deg, len_sums) -> ReportArrays:
        """Constraint columns [P] in host float64, exact against
        ``core.reports`` (the per-mm link-power term uses the device's f32
        length sums; it is zero under default packaging)."""
        from ..core.reports import adjacency_connected_fraction
        pkg = self.space.packaging
        n = self.n
        radix = np.clip(deg.max(axis=1), 1, self.k_phys)
        n_links = (np.asarray(genomes, np.int64) % 2).sum(axis=1)
        power = (n * self._chip_power[radix]
                 + pkg.link_power_const * n_links
                 + pkg.link_power_per_mm * np.asarray(len_sums, np.float64))
        return ReportArrays(
            total_chiplet_area=n * self._chip_area[radix],
            interposer_area=self._ia[radix],
            power=power,
            cost=self._cost[radix],
            reachable_fraction=adjacency_connected_fraction(
                genomes, self.space.pair_u, self.space.pair_v, n))


# ---------------------------------------------------------------------------
# ParametricSpace: structure-table gather
# ---------------------------------------------------------------------------

class ParametricPipeline:
    """Structure-table device path for ``opt.space.ParametricSpace``: the
    finite set of decodable structures is built lazily on the host (through
    the shared structure cache, so sweeps and optimizers reuse each other's
    builds) and stacked; each population is an index gather plus the sweep
    engine's batched proxies. The population is sharded over ``devices``
    (one device or a sequence, repeats allowed); the structure stack is
    replicated once per distinct device."""

    def __init__(self, space, devices):
        self.space = space
        self.devices = resolve_devices(devices)
        self.device = self.devices[0]
        self.n = node_bucket(space.max_nodes)
        self.n_steps = num_doubling_steps(self.n)
        # the safety bound; the flow loop stops at the routed diameter
        self.max_hops = max(self.n - 1, 1)
        # Guards the lazily grown structure tables: jobs sharing this
        # pipeline may add structures concurrently.
        self._lock = threading.RLock()
        self._sid: dict[tuple, int] = {}
        self._rows: dict[str, list[np.ndarray]] = {
            k: [] for k in ("next_hop", "step_cost", "node_weight", "adj_bw",
                            "traffic")}
        self._reports: list[tuple] = []
        # device -> name -> stacked tables; emptied when structures grow
        self._stacked: dict[torch.device, dict[str, torch.Tensor]] = {}

    def _point_for(self, key: tuple):
        from .sweep import DesignPoint
        ti, ci, ri, beff = key
        sp = self.space
        return DesignPoint(
            index=0, topology=sp.topologies[ti],
            n_chiplets=sp.chiplet_counts[ci],
            traffic_pattern=sp.traffic_pattern, routing=sp.routings[ri],
            seed=sp.seed, shg_bits=beff, packaging=sp.packaging,
            technology=sp.technology)

    def _key_of(self, genome: np.ndarray) -> tuple:
        from ..topologies.grid import grid_dims
        sp = self.space
        ti, ci, ri, bi = (int(x) for x in genome)
        beff = 0
        if sp.topologies[ti] == "shg":
            r, c = grid_dims(sp.chiplet_counts[ci])
            beff = int(sp.shg_bits_choices[bi]) % 2 ** (r + c - 4)
        return (ti, ci, ri, beff)

    def _ensure(self, keys) -> None:
        from ..core.reports import report_arrays
        from ..core.structure_cache import GLOBAL_STRUCTURE_CACHE
        from .batch import _structures_for

        missing = [k for k in dict.fromkeys(keys) if k not in self._sid]
        if not missing:
            return
        n = self.n
        points = [self._point_for(k) for k in missing]
        entries = _structures_for(points, validate=False,
                                  cache=GLOBAL_STRUCTURE_CACHE,
                                  keep_designs=True)
        designs = []
        for key, pt in zip(missing, points):
            entry = entries[pt.structure_key()]
            arrays = entry.arrays
            k = arrays.next_hop.shape[0]
            nc = arrays.n_chiplets
            nh = np.tile(np.arange(n, dtype=np.int16)[:, None], (1, n))
            nh[:k, :k] = arrays.next_hop
            sc = np.zeros((n, n), np.float32)
            sc[:k, :k] = arrays.step_cost
            nw = np.zeros(n, np.float32)
            nw[:k] = arrays.node_weight
            bwm = np.zeros((n, n), np.float32)
            bwm[:k, :k] = arrays.adj_bw
            tr = np.zeros((n, n), np.float32)
            tr[:nc, :nc] = pt.traffic()
            self._sid[key] = len(self._rows["next_hop"])
            for name, x in (("next_hop", nh), ("step_cost", sc),
                            ("node_weight", nw), ("adj_bw", bwm),
                            ("traffic", tr)):
                self._rows[name].append(x)
            design = entry.extra.get("design")
            designs.append(design if design is not None else pt.build())
        rep = report_arrays(designs)
        for i in range(len(missing)):
            self._reports.append((rep.total_chiplet_area[i],
                                  rep.interposer_area[i],
                                  rep.power[i], rep.cost[i]))
        self._stacked = {}

    def evaluate_async(self, genomes: np.ndarray) -> PendingGenomeEval:
        """Gather the population's structures (built on the host first) and
        launch the proxies without waiting for the device."""
        genomes = self.space.repair(np.asarray(genomes, np.int64))
        Pn = len(genomes)
        with _span("genomes.dispatch", space="parametric", pop=Pn,
                   n=self.n, shards=len(self.devices)) as sp:
            keys = [self._key_of(g) for g in genomes]
            with self._lock:
                n_known = len(self._sid)
                with _span("genomes.build_structures"):
                    self._ensure(keys)
                sp.set(new_structures=len(self._sid) - n_known)
                sids = np.asarray([self._sid[k] for k in keys], np.int64)
                if not self._stacked:
                    host = {k: np.stack(v) for k, v in self._rows.items()}
                    self._stacked = {
                        dev: {k: torch.as_tensor(v, device=dev)
                              for k, v in host.items()}
                        for dev in dict.fromkeys(self.devices)}
                stacked = self._stacked
            bp = bucket_population(Pn, len(self.devices))
            gsids = sids
            if bp != Pn:
                gsids = np.concatenate([sids, np.repeat(sids[-1:], bp - Pn)])
            outs = []
            for dev, idx in zip(self.devices, shard_rows(
                    gsids, self.devices, torch.int64)):
                args = [stacked[dev][k][idx]
                        for k in ("next_hop", "step_cost", "node_weight",
                                  "adj_bw", "traffic")]
                with on_device(dev), torch.no_grad():
                    outs.append(batched_evaluate(
                        *args, n_steps=self.n_steps, max_hops=self.max_hops))
        lat, thr = zip(*outs)

        def finish() -> GenomeEvalResult:
            with _span("genomes.finish", space="parametric", pop=Pn):
                with self._lock:
                    cols = np.asarray([self._reports[s] for s in sids],
                                      np.float64)
                reports = ReportArrays(total_chiplet_area=cols[:, 0],
                                       interposer_area=cols[:, 1],
                                       power=cols[:, 2], cost=cols[:, 3])
                return GenomeEvalResult(latency=gather_rows(lat, Pn),
                                        throughput=gather_rows(thr, Pn),
                                        reports=reports)

        return _pending(self.devices, finish)

    def evaluate(self, genomes: np.ndarray) -> GenomeEvalResult:
        """Blocking wrapper over ``evaluate_async``."""
        return self.evaluate_async(genomes).result()


def make_pipeline(space, devices):
    """Pipeline for a search space sharded over ``devices`` (one device or
    a sequence), or None when only the host path applies (adjacency spaces
    routed with the RNG-streamed updown_random)."""
    from ..opt.space import AdjacencySpace, ParametricSpace

    if isinstance(space, AdjacencySpace):
        if space.routing != "dijkstra_lowest_id":
            return None
        return AdjacencyPipeline(space, devices)
    if isinstance(space, ParametricSpace):
        return ParametricPipeline(space, devices)
    return None


__all__ = ["bucket_population", "node_bucket", "NODE_TILE",
           "PendingGenomeEval", "GenomeEvalResult", "FaultGridResult",
           "AdjacencyPipeline",
           "ParametricPipeline", "make_pipeline"]
