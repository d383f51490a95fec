"""Latency proxy (paper §2.1.2) in PyTorch; port of
``src/repro/core/latency.py``.

All per-pair path costs come at once from **path doubling** over the
next-hop matrix:

    pos_1[u, d]  = next_hop[u, d]
    cost_1[u, d] = step_cost[u, next_hop[u, d]]          (0 if u == d)
    pos_2k[u, d]  = pos_k[pos_k[u, d], d]
    cost_2k[u, d] = cost_k[u, d] + cost_k[pos_k[u, d], d]

After ceil(log2(n)) + 1 doublings every route of length <= n-1 has
converged (pos == d). ``step_cost[u, v] = node_weight[u] + edge_latency[u,
v]`` and the destination's vertex weight is added once at the end, so the
per-pair cost is the sum of all vertex and edge weights on the path, as the
paper specifies.

Every function takes [n, n] tensors or a batch [B, n, n] written out (the
reference vmapped the 2-D form) and runs on the tensors' device.
``path_cost_minplus`` is not ported yet (it waits for the min-plus kernel).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device


def num_doubling_steps(n: int) -> int:
    """Doublings needed so paths of length <= n-1 converge."""
    return max(1, math.ceil(math.log2(max(n - 1, 2))) + 1)


def path_cost_doubling(next_hop: torch.Tensor, step_cost: torch.Tensor,
                       node_weight: torch.Tensor, n_steps: int | None = None
                       ) -> torch.Tensor:
    """Per-pair path cost under a next-hop routing table.

    next_hop: int [n, n] or [B, n, n]; next_hop[d, d] = d and
    next_hop[u, d] = u marks "no route". step_cost: float, same shape; cost
    of leaving u over edge (u, v). node_weight: float [n] or [B, n];
    destination vertex weight added at the end.

    Returns float32 of next_hop's shape; entry (s, d) is the total path
    weight from s to d, +inf where unreachable, node_weight[d] on the
    diagonal.
    """
    squeeze = next_hop.dim() == 2
    if squeeze:
        next_hop, step_cost = next_hop[None], step_cost[None]
        node_weight = node_weight[None]
    n = next_hop.shape[-1]
    if n_steps is None:
        n_steps = num_doubling_steps(n)
    dev = next_hop.device
    ids = torch.arange(n, device=dev)
    pos = next_hop.long()
    first_cost = torch.gather(step_cost, 2, pos)
    zero = torch.zeros((), dtype=first_cost.dtype, device=dev)
    cost = torch.where(pos == ids[:, None], zero, first_cost)
    for _ in range(n_steps):
        # cost2[u, d] = cost[u, d] + cost[pos[u, d], d]; pos2 = pos[pos, d]
        cost = cost + torch.gather(cost, 1, pos)
        pos = torch.gather(pos, 1, pos)
    reached = pos == ids
    total = cost + node_weight[:, None, :]
    inf = torch.full((), torch.inf, dtype=total.dtype, device=dev)
    out = torch.where(reached, total, inf).to(torch.float32)
    return out[0] if squeeze else out


def routed_hops(next_hop: torch.Tensor, n_steps: int | None = None
                ) -> torch.Tensor:
    """Hop count of every routed path (+inf where unreachable).
    ``int(max finite)`` is the exact routed diameter — the tight static hop
    bound for the flow accumulation in the throughput proxy."""
    n = next_hop.shape[-1]
    lead = next_hop.shape[:-2]
    ones = torch.ones((*lead, n, n), dtype=torch.float32,
                      device=next_hop.device)
    zeros = torch.zeros((*lead, n), dtype=torch.float32,
                        device=next_hop.device)
    return path_cost_doubling(next_hop, ones, zeros, n_steps)


def _max_finite(hops: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=hops.dtype, device=hops.device)
    return torch.where(torch.isfinite(hops), hops, zero).amax(dim=(-2, -1))


def routed_diameter(next_hop: torch.Tensor) -> int:
    """Routed diameter of one [n, n] table (on the table's device)."""
    return int(_max_finite(routed_hops(next_hop)))


def routed_diameter_batch(next_hop_batch, device=None) -> np.ndarray:
    """int64 [B] of routed diameters (>= 1 each, so the result is directly
    usable as a flow-accumulation hop bound). A tensor stays on its device;
    a numpy array goes to ``device`` (None -> cuda). Padded vertices route
    to themselves (= unreachable) and are masked out, so padded and unpadded
    tables give the same diameter."""
    nh = next_hop_batch
    if not isinstance(nh, torch.Tensor):
        nh = torch.as_tensor(np.asarray(nh), device=resolve_device(device))
    dias = _max_finite(routed_hops(nh, num_doubling_steps(nh.shape[-1])))
    return np.maximum(dias.cpu().numpy().astype(np.int64), 1)


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last two dims by pairwise halving, one elementwise add
    per level. The order of the additions depends on the matrix size only,
    so a design's sum has the same bits alone or in a batch; ``torch.sum``
    on CUDA picks its reduction order by the whole tensor's shape."""
    flat = x.flatten(-2)
    m = flat.shape[-1]
    width = 1 << max(m - 1, 0).bit_length()
    if width != m:
        flat = torch.nn.functional.pad(flat, (0, width - m))
    while flat.shape[-1] > 1:
        half = flat.shape[-1] // 2
        flat = flat[..., :half] + flat[..., half:]
    return flat[..., 0]


def latency_proxy(path_cost: torch.Tensor, traffic: torch.Tensor
                  ) -> torch.Tensor:
    """Paper §2.1.2: traffic-weighted average packet latency.

        L = sum_{(s,d,a)} a * path_cost(s,d) / sum a

    ``path_cost`` and ``traffic`` have matching [.., n_c, n_c] shapes;
    pad/crop is the caller's job. Returns a scalar, or [B] for a batch."""
    t = traffic
    zero = torch.zeros((), dtype=path_cost.dtype, device=t.device)
    num = pairwise_sum(torch.where(t > 0, t * path_cost, zero))
    return (num / pairwise_sum(t)).to(torch.float32)


def average_latency(next_hop: torch.Tensor, step_cost: torch.Tensor,
                    node_weight: torch.Tensor, traffic: torch.Tensor,
                    n_steps: int | None = None) -> torch.Tensor:
    """Path doubling + traffic-weighted mean; traffic may cover the
    chiplets only (the routers' rows and columns are cropped)."""
    n_c = traffic.shape[-1]
    plat = path_cost_doubling(next_hop, step_cost, node_weight, n_steps)
    return latency_proxy(plat[..., :n_c, :n_c], traffic)


__all__ = ["num_doubling_steps", "path_cost_doubling", "routed_hops",
           "routed_diameter", "routed_diameter_batch", "pairwise_sum",
           "latency_proxy", "average_latency"]
