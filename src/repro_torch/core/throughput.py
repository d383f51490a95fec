"""Throughput proxy (paper §2.1.3) in PyTorch; port of
``src/repro/core/throughput.py``.

Two edge properties are needed: the bandwidth B({u,v}) (computed at graph
construction from bump geometry) and the flow F({u,v}) — the sum of all
traffic routed over the edge. The proxy is then

    T = min_{e in E} B(e) / F(e) * total_traffic.

F comes from the shared load-propagation primitive
``kernels.ops.load_propagate``: the hand-written kernel on CUDA, its plain
version on the CPU. Every function takes [n, n] tensors or a batch
[B, n, n] written out. The reference's ``use_kernel=True`` pair walk (an
independent oracle through the scatter-as-matmul kernel) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ops import load_propagate
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


def edge_flows(next_hop: torch.Tensor, traffic: torch.Tensor,
               max_hops: int | None = None,
               adaptive: bool = False) -> torch.Tensor:
    """Directed edge flows: flow[u, v] = total traffic traversing the
    directed channel u->v under the routing table. traffic is
    [n_chiplets, n_chiplets]; routers never source traffic.

    Unreachable pairs (next_hop self-loops) never deliver, so they
    accumulate on the diagonal for exactly ``max_hops`` hops (default
    n - 1); zero-bandwidth self-edges then drive the proxy to 0.
    ``adaptive`` lets the plain version stop once every route has
    delivered; the result is the same."""
    n = next_hop.shape[-1]
    if max_hops is None:
        max_hops = n - 1
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
                     directed: bool = False,
                     adaptive: bool = False) -> torch.Tensor:
    """Paper §2.1.3:

        T = min_{u,v} B({u,v}) / F({u,v}) * sum(traffic)

    Edges with zero flow do not constrain the minimum. Returns float32 (a
    scalar, or [B] for a batch) in units of total offered traffic.
    ``directed=True`` evaluates each direction against B separately (the
    full-duplex model a simulator uses)."""
    flow_dir = edge_flows(next_hop, traffic, max_hops, adaptive)
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
