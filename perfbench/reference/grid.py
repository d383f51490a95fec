"""Plain reference of the fault-aware genome cost function: from raw
offspring to (latency, throughput, reachable fraction) of every genome
under every fault scenario, and each genome's report columns.

It shares nothing with the program: repair is the sequential oracle
(``repair.py``); PHY geometry is the host's greedy nearest-PHY rule in
float64, run over the population in lockstep; routing is a BFS over
neighbour lists (no matrix product) with the lowest-ID neighbour one hop
nearer the destination; and the proxies come from walking every delivered
(source, destination) pair along its route, adding its path cost and its
traffic onto each edge it crosses (no load propagation). Rows are taken in
blocks so that the walk's state stays a few hundred MB at any size.

``precision="float64"`` is the reference. ``precision="bfloat16"`` is the
control: the same computation with every floating value it carries rounded
to bfloat16 after each step (lengths, latencies, step costs, bandwidths,
traffic, the running path costs and edge flows, the ratios).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .chiplets import (INTERNAL_LATENCY, PACKAGING, PHY_LATENCY, SPACING,
                       RadixTables, grid_dims)
from .repair import repair

BIG = 1e18
PHY_TIE_TOL = 1e-9
ROW_ELEMS = 150_000_000     # gathered BFS elements a block may hold


@dataclass
class GridResult:
    repaired: np.ndarray            # [P, G] int64
    latency: np.ndarray             # [P, F] f64 (BIG where nothing routes)
    throughput: np.ndarray          # [P, F] f64 (0 where nothing routes)
    reachable_fraction: np.ndarray  # [P, F] f64
    reports: dict                   # column -> [P] f64


def _rounder(precision: str):
    if precision == "float64":
        return torch.float64, (lambda x: x)
    if precision == "bfloat16":
        return torch.float32, (lambda x: x.to(torch.bfloat16).to(torch.float32))
    raise ValueError(f"unknown precision {precision!r}")


def geometry(bits: np.ndarray, n: int, k: int, tables: RadixTables):
    """Greedy nearest-PHY assignment and link geometry of every genome, in
    float64: links in ascending grid length (ties by pair index); each
    endpoint takes the first free PHY of its chiplet whose Manhattan
    distance to the other chiplet's centre no later PHY beats by more than
    a relative 1e-9. Returns (degrees [P, n], radix [P], pair lengths
    [P, G] with 0 where no link)."""
    P, G = bits.shape
    pu, pv = (x.astype(np.int64) for x in np.triu_indices(n, k=1))
    rows, cols = grid_dims(n)
    col = (np.arange(n) % cols).astype(np.float64)
    row = (np.arange(n) // cols).astype(np.float64)
    deg = np.zeros((P, n), np.int64)
    for p in range(P):
        s = np.nonzero(bits[p])[0]
        np.add.at(deg[p], pu[s], 1)
        np.add.at(deg[p], pv[s], 1)
    radix = np.clip(deg.max(axis=1), 1, k)
    side = tables.side[radix]
    pitch = side + SPACING
    posx = col[None, :] * pitch[:, None]
    posy = row[None, :] * pitch[:, None]
    gridd = np.abs(col[pu] - col[pv]) + np.abs(row[pu] - row[pv])
    order = np.lexsort((np.arange(G), gridd))
    ordered = bits[:, order] == 1
    counts = ordered.sum(axis=1)
    steps = int(counts.max(initial=0))
    # each genome's links in processing order, padded with -1
    slot = np.full((P, max(steps, 1)), -1, np.int64)
    for p in range(P):
        slot[p, :counts[p]] = order[ordered[p]]
    used = np.zeros((P, n, k), bool)
    pick = np.zeros((P, G, 2), np.int64)
    ar = np.arange(P)
    phyx, phyy = tables.phy[radix, :, 0], tables.phy[radix, :, 1]  # [P, k]
    for t in range(steps):
        g = slot[:, t]
        live = g >= 0
        gg = np.where(live, g, 0)
        for end, (a, b) in enumerate(((pu[gg], pv[gg]), (pv[gg], pu[gg]))):
            tx = posx[ar, b] + side / 2
            ty = posy[ar, b] + side / 2
            best = np.full(P, -1, np.int64)
            best_d = np.full(P, np.inf)
            for pi in range(k):
                free = (pi < radix) & ~used[ar, a, pi]
                d = (np.abs(posx[ar, a] + phyx[:, pi] - tx)
                     + np.abs(posy[ar, a] + phyy[:, pi] - ty))
                with np.errstate(invalid="ignore"):   # inf - inf: no best yet
                    better = d < best_d - PHY_TIE_TOL * np.maximum(best_d, 1.0)
                take = free & ((best < 0) | better)
                best = np.where(take, pi, best)
                best_d = np.where(take, d, best_d)
            if (live & (best < 0)).any():
                raise ValueError("a chiplet ran out of PHYs")
            used[ar[live], a[live], best[live]] = True
            pick[ar[live], gg[live], end] = best[live]
    ax = posx[:, pu] + np.take_along_axis(phyx, pick[:, :, 0], 1)
    ay = posy[:, pu] + np.take_along_axis(phyy, pick[:, :, 0], 1)
    bx = posx[:, pv] + np.take_along_axis(phyx, pick[:, :, 1], 1)
    by = posy[:, pv] + np.take_along_axis(phyy, pick[:, :, 1], 1)
    length = np.where(bits == 1, np.abs(ax - bx) + np.abs(ay - by), 0.0)
    return deg, radix, length


def _neighbours(adj: torch.Tensor, k: int) -> torch.Tensor:
    """Neighbour ids [b, n, k] in ascending order, ``n`` where none."""
    n = adj.shape[-1]
    ids = torch.arange(n, device=adj.device)
    key = torch.where(adj, ids, n)
    return torch.sort(key, dim=-1).values[..., :k]


def _gather_rows(dist_pad: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """dist_pad [b, n + 1, n] at the neighbour rows: [b, n, k, n]."""
    b, n, k = nbr.shape
    idx = nbr.reshape(b, n * k, 1).expand(b, n * k, dist_pad.shape[-1])
    return torch.gather(dist_pad, 1, idx).view(b, n, k, -1)


def route(adj: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Hop distances dist[b, u, d] (``n`` = unreachable) by BFS from every
    destination over the neighbour lists, and the next hop nh[b, u, d]:
    the lowest-ID neighbour one hop nearer d (u itself where d is u or out
    of reach)."""
    b, n, _ = adj.shape
    dev = adj.device
    nbr = _neighbours(adj, k)
    ids = torch.arange(n, device=dev)
    eye = ids[:, None] == ids[None, :]
    dist = torch.where(eye, 0, n).to(torch.int16).expand(b, n, n).clone()
    pad = torch.full((b, 1, n), n, dtype=torch.int16, device=dev)
    for step in range(1, n):
        near = _gather_rows(torch.cat([dist, pad], 1), nbr)
        new = (near == step - 1).any(dim=2) & (dist == n)
        if not bool(new.any()):
            break
        dist = torch.where(new, step, dist).to(torch.int16)
    near = _gather_rows(torch.cat([dist, pad], 1), nbr)
    hit = (near == (dist[:, :, None, :] - 1)) & (nbr < n)[..., None]
    first = torch.argmax(hit.to(torch.uint8), dim=2)             # [b, u, d]
    nh = torch.gather(nbr, 2, first)
    take = (dist < n) & ~eye
    return dist, torch.where(take, nh, ids[None, :, None])


def walk(nh, dist, step_cost, bw, traffic, node_ok, rnd):
    """Every delivered pair walked along its route. Returns (latency,
    throughput, reachable fraction) per row."""
    b, n, _ = nh.shape
    dev = nh.device
    ids = torch.arange(n, device=dev)
    src = ids[None, :, None].expand(b, n, n)
    dst = ids[None, None, :].expand(b, n, n)
    deliver = ((dist < n) & (src != dst) & node_ok[:, :, None]
               & node_ok[:, None, :])
    amount = torch.where(deliver, rnd(traffic)[None], 0.0)
    t_tot = rnd(amount.sum(dim=(1, 2)))
    cost = rnd((amount * INTERNAL_LATENCY).sum(dim=(1, 2)))
    flow = torch.zeros((b, n * n), dtype=amount.dtype, device=dev)
    sc = step_cost.reshape(b, n * n)
    cur = src.clone()
    active = deliver.clone()
    while bool(active.any()):
        nxt = torch.gather(nh, 1, cur)
        edge = (cur * n + nxt).reshape(b, n * n)
        part = torch.where(active, amount, 0.0).reshape(b, n * n)
        cost = rnd(cost + rnd(rnd(part * torch.gather(sc, 1, edge)).sum(1)))
        flow = rnd(flow.scatter_add(1, edge, part))
        cur = torch.where(active, nxt, cur)
        active = active & (cur != dst)
    f = flow.view(b, n, n)
    f = rnd(f + f.transpose(1, 2))
    ratio = torch.where(f > 0, rnd(bw / torch.clamp_min(f, 1e-30)), torch.inf)
    routed = t_tot > 0
    lat = torch.where(routed, rnd(cost / torch.clamp_min(t_tot, 1e-30)), BIG)
    thr = torch.where(routed, rnd(ratio.amin(dim=(1, 2)) * t_tot), 0.0)
    reach = rnd(t_tot / rnd(traffic.sum()))
    return lat, thr, reach


def evaluate(raw: np.ndarray, link_fail: np.ndarray, node_fail: np.ndarray,
             n: int, max_degree: int, device="cpu",
             precision: str = "float64",
             row_elems: int = ROW_ELEMS) -> GridResult:
    """The reference over one call: raw offspring [P, G], the scenarios'
    masks [F, G] and [F, n]."""
    dtype, rnd = _rounder(precision)
    dev = torch.device(device)
    k = max(min(n - 1, max_degree + 1), 1)
    tables = RadixTables(n, k)
    bits = repair(raw, n, max_degree)
    P, G = bits.shape
    F = len(link_fail)
    deg, radix, length = geometry(bits, n, k, tables)
    pu, pv = (x.astype(np.int64) for x in np.triu_indices(n, k=1))
    area = tables.area[radix]
    bwl = np.minimum(tables.bw[radix[:, None], deg[:, pu]],
                     tables.bw[radix[:, None], deg[:, pv]])
    pair_id = np.full((n, n), G, np.int64)
    pair_id[pu, pv] = np.arange(G)
    pair_id[pv, pu] = np.arange(G)

    def dense(x_pairs):                  # [P, G] -> [P, n, n], 0 off-link
        padded = np.concatenate([x_pairs, np.zeros((len(x_pairs), 1))], 1)
        return torch.as_tensor(padded[:, pair_id], dtype=dtype, device=dev)

    bits_t = torch.as_tensor(np.concatenate(
        [bits, np.zeros((P, 1), np.int64)], 1)[:, pair_id] == 1, device=dev)
    length_t = rnd(dense(length))
    lat_t = rnd(rnd(PACKAGING["link_latency_const"]
                    + rnd(PACKAGING["link_latency_per_mm"] * length_t))
                + 2 * PHY_LATENCY)
    step_cost = torch.where(bits_t, rnd(INTERNAL_LATENCY + lat_t), 0.0)
    bw = rnd(dense(np.where(bits == 1, bwl, 0.0)))
    traffic = torch.ones((n, n), dtype=dtype, device=dev)
    traffic.fill_diagonal_(0.0)
    traffic = traffic / traffic.sum()

    alive_pairs = torch.as_tensor(np.concatenate(
        [~link_fail, np.ones((F, 1), bool)], 1)[:, pair_id], device=dev)
    node_ok = torch.as_tensor(~node_fail, device=dev)
    rows = P * F
    block = max(1, row_elems // (n * k * n))
    lat = np.zeros(rows)
    thr = np.zeros(rows)
    reach = np.zeros(rows)
    for r0 in range(0, rows, block):
        r = torch.arange(r0, min(r0 + block, rows), device=dev)
        p, f = r // F, r % F
        ok = node_ok[f]
        adj = (bits_t[p] & alive_pairs[f] & ok[:, :, None] & ok[:, None, :])
        dist, nh = route(adj, k)
        out = walk(nh, dist, step_cost[p], bw[p], traffic, ok, rnd)
        for dst_arr, x in zip((lat, thr, reach), out):
            dst_arr[r0:r0 + len(r)] = x.double().cpu().numpy()
    # the connected fraction of each pristine genome
    connected = np.zeros(P)
    for r0 in range(0, P, block):
        dist, _ = route(bits_t[r0:r0 + block], k)
        reached = ((dist < n).sum(dim=(1, 2)) - n).double().cpu().numpy()
        connected[r0:r0 + block] = reached / (n * (n - 1))
    n_links = bits.sum(axis=1)
    hdt = np.float64 if precision == "float64" else np.float32
    reports = {
        "total_chiplet_area": (n * area).astype(hdt),
        "interposer_area": tables.interposer[radix].astype(hdt),
        "power": (n * tables.power[radix]
                  + PACKAGING["link_power_const"] * n_links
                  + PACKAGING["link_power_per_mm"] * length.sum(axis=1)
                  ).astype(hdt),
        "cost": tables.cost[radix].astype(hdt),
        "reachable_fraction": connected.astype(hdt),
    }
    return GridResult(repaired=bits, latency=lat.reshape(P, F),
                      throughput=thr.reshape(P, F),
                      reachable_fraction=reach.reshape(P, F),
                      reports={c: v.astype(np.float64)
                               for c, v in reports.items()})
