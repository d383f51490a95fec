"""Throughput proxy (paper §2.1.3) in PyTorch; port of
``src/repro/core/throughput.py``.

Two edge properties are needed: the bandwidth B({u,v}) (computed at graph
construction from bump geometry) and the flow F({u,v}) — the sum of all
traffic routed over the edge. The proxy is then

    T = min_{e in E} B(e) / F(e) * total_traffic.

F comes from the shared load-propagation primitive
``kernels.ops.load_propagate``: the hand-written kernel on CUDA, its plain
version on the CPU. ``use_kernel=True`` instead walks every route hop by hop
and adds each hop's traffic onto its edge with ``kernels.ops.flow_accumulate``
(the flow-accumulation kernel on CUDA), an independent oracle of the same
flows. Every function takes [n, n] tensors or a batch [B, n, n] written out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ops import flow_accumulate, load_propagate
from .latency import pairwise_sum


def _dest_major_load0(next_hop: torch.Tensor, traffic: torch.Tensor
                      ) -> torch.Tensor:
    """Initial dest-major load L0[d, u] from a (possibly router-padded)
    traffic matrix: traffic[s, d] starts residing at s, destined for d."""
    n = next_hop.shape[-1]
    n_c = traffic.shape[-1]
    t = traffic.to(torch.float32)
    if n_c != n:
        t = F.pad(t, (0, n - n_c, 0, n - n_c))
    return t.transpose(-1, -2)


def _pair_walk(next_hop: torch.Tensor, traffic: torch.Tensor, max_hops: int,
               adaptive: bool) -> torch.Tensor:
    """The reference's ``use_kernel=True`` walk: all n^2 (source, dest)
    pairs step together, one hop per iteration, and each hop's traffic is
    added onto its edge (cur, nxt) by ``ops.flow_accumulate``."""
    squeeze = next_hop.dim() == 2
    nh = next_hop[None] if squeeze else next_hop
    B, n, _ = nh.shape
    dev = nh.device
    t = _dest_major_load0(nh, traffic).transpose(-1, -2)     # src-major
    amount = t.reshape(-1, n * n).expand(B, n * n).contiguous()
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    dest = ids.repeat(n)[None].expand(B, n * n)
    cur = ids.repeat_interleave(n)[None].expand(B, n * n).contiguous()
    nh_flat = nh.to(torch.int32).reshape(B, n * n)
    live = amount > 0
    flow = torch.zeros((B, n, n), dtype=torch.float32, device=dev)
    for _ in range(max_hops):
        active = (cur != dest) & live
        if adaptive and not bool(active.any()):
            break
        nxt = torch.gather(nh_flat, 1, (cur * n + dest).long())
        flow = flow_accumulate(flow, cur, nxt, torch.where(active, amount, 0.0))
        cur = torch.where(active, nxt, cur)
    return flow[0] if squeeze else flow


def edge_flows(next_hop: torch.Tensor, traffic: torch.Tensor,
               max_hops: int | None = None, use_kernel: bool = False,
               adaptive: bool = False) -> torch.Tensor:
    """Directed edge flows: flow[u, v] = total traffic traversing the
    directed channel u->v under the routing table. traffic is
    [n_chiplets, n_chiplets]; routers never source traffic.

    The default goes through load propagation (``ops.load_propagate``).
    ``use_kernel=True`` runs the per-route pair walk through the
    flow-accumulation kernel instead, an independent implementation kept
    as an oracle. Unreachable pairs (next_hop self-loops) never deliver, so
    both accumulate them on the diagonal for exactly ``max_hops`` hops
    (default n - 1); zero-bandwidth self-edges then drive the proxy to 0.
    ``adaptive`` lets the loops stop once every route has delivered; the
    result is the same."""
    n = next_hop.shape[-1]
    if max_hops is None:
        max_hops = n - 1
    if use_kernel:
        return _pair_walk(next_hop, traffic, max_hops, adaptive)
    _, flow = load_propagate(next_hop, _dest_major_load0(next_hop, traffic),
                             max_hops=max_hops, adaptive=adaptive)
    return flow


def edge_flows_load(next_hop: torch.Tensor, traffic: torch.Tensor,
                    max_hops: int | None = None,
                    adaptive: bool = True) -> torch.Tensor:
    """``edge_flows`` with the primitive's own hop default (max(n-1, 1))
    and adaptive stopping on."""
    _, flow = load_propagate(next_hop, _dest_major_load0(next_hop, traffic),
                             max_hops=max_hops, adaptive=adaptive)
    return flow


def undirected_flows(flow: torch.Tensor) -> torch.Tensor:
    """Paper models links as undirected: F({u,v}) sums both directions."""
    return flow + flow.transpose(-1, -2)


def _bw_ratio(f: torch.Tensor, adj_bw: torch.Tensor) -> torch.Tensor:
    bw = adj_bw.to(torch.float32)
    inf = torch.full((), torch.inf, dtype=torch.float32, device=f.device)
    return torch.where(f > 0, bw / torch.clamp_min(f, 1e-30), inf)


def throughput_proxy(next_hop: torch.Tensor, adj_bw: torch.Tensor,
                     traffic: torch.Tensor, max_hops: int | None = None,
                     use_kernel: bool = False, directed: bool = False,
                     adaptive: bool = False) -> torch.Tensor:
    """Paper §2.1.3:

        T = min_{u,v} B({u,v}) / F({u,v}) * sum(traffic)

    Edges with zero flow do not constrain the minimum. Returns float32 (a
    scalar, or [B] for a batch) in units of total offered traffic.
    ``directed=True`` evaluates each direction against B separately (the
    full-duplex model a simulator uses). ``use_kernel=True`` takes the
    flows from the pair walk (``edge_flows``)."""
    flow_dir = edge_flows(next_hop, traffic, max_hops, use_kernel, adaptive)
    f = flow_dir if directed else undirected_flows(flow_dir)
    min_ratio = _bw_ratio(f, adj_bw).amin(dim=(-2, -1))
    total = pairwise_sum(traffic.to(torch.float32))
    return (min_ratio * total).to(torch.float32)


def reachable_fraction(next_hop: torch.Tensor, traffic: torch.Tensor
                       ) -> torch.Tensor:
    """Traffic-weighted fraction of reachable source/destination pairs:
    1.0 iff every pair with traffic can route. next_hop: [n, n] or
    [B, n, n]; traffic [n_c, n_c] (router-padded internally). Returns a
    scalar or [B]."""
    squeeze = next_hop.dim() == 2
    if squeeze:
        next_hop = next_hop[None]
    n = next_hop.shape[-1]
    t = _dest_major_load0(next_hop[0], traffic).transpose(-1, -2)  # src-major
    ids = torch.arange(n, device=next_hop.device)
    reach = (next_hop != ids[None, :, None]) | (ids[:, None] == ids)[None]
    total = torch.clamp_min(t.sum(), 1e-30)
    frac = ((t[None] * reach).sum(dim=(1, 2)) / total).to(torch.float32)
    return frac[0] if squeeze else frac


def bottleneck_edges(next_hop: torch.Tensor, adj_bw: torch.Tensor,
                     traffic: torch.Tensor, max_hops: int | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Diagnostics for DSE: per-edge saturation ratio B/F (lower = closer
    to the bottleneck) and the argmin edge index (u*n+v)."""
    f_und = undirected_flows(edge_flows(next_hop, traffic, max_hops))
    ratio = _bw_ratio(f_und, adj_bw)
    return ratio, ratio.flatten(-2).argmin(dim=-1)


__all__ = ["edge_flows", "edge_flows_load", "undirected_flows",
           "throughput_proxy", "reachable_fraction", "bottleneck_edges"]
