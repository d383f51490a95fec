"""Public entry of the port's kernels (port of ``src/repro/kernels/ops.py``;
``load_propagate`` only so far).

The route follows the tensor's device and nothing else: a CUDA tensor
launches the hand-written kernel or raises, and only a CPU tensor takes the
plain PyTorch version. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from ..utils import env as _env
from . import load_prop as _lp


def load_propagate(next_hop: torch.Tensor, load0: torch.Tensor,
                   max_hops: int | None = None, adaptive: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulated per-destination load and directed edge flows.

    next_hop: [n, n] or [B, n, n] routing table (src-major: next_hop[u, d]
    is u's next hop toward d; unreachable pairs self-loop). load0: matching
    dest-major initial load (load0[d, u] = traffic at u bound for d; the
    diagonal is masked off). Returns

        W[d, u]    = Σ_j L_j[d, u]  over ``max_hops`` hops (default n - 1),
        flow[u, v] = Σ_d [next_hop[u, d] = v] · W[d, u].

    On CUDA: ``load_prop.load_prop_cuda``. On the CPU: the dense plain form
    up to ``REPRO_LOAD_PROP_FUSED_N`` nodes, the slab form above it (tile
    from ``REPRO_LOAD_PROP_TILE`` or ``load_prop.pick_tile``). ``adaptive``
    lets the plain forms stop once no load is left; the kernel always stops
    a slab whose load is all zero. Both give the fixed-hop result exactly,
    since the skipped hops add zeros.
    """
    if next_hop.shape[-2:] != load0.shape[-2:] or next_hop.dim() != load0.dim():
        raise ValueError(f"next_hop {tuple(next_hop.shape)} and load0 "
                         f"{tuple(load0.shape)} do not match")
    if next_hop.device != load0.device:
        raise ValueError(f"next_hop on {next_hop.device}, load0 on "
                         f"{load0.device}")
    squeeze = next_hop.dim() == 2
    if squeeze:
        next_hop, load0 = next_hop[None], load0[None]
    B, n, _ = next_hop.shape
    if max_hops is None:
        max_hops = max(n - 1, 1)
    dev = next_hop.device.type
    if dev == "cuda":
        w, flow = _lp.load_prop_cuda(
            next_hop.to(torch.int32).contiguous(),
            load0.to(torch.float32).contiguous(), max_hops)
    elif dev == "cpu":
        if n > _env.get_int("REPRO_LOAD_PROP_FUSED_N"):
            tile = (_env.get_opt_int("REPRO_LOAD_PROP_TILE")
                    or _lp.pick_tile(n, B))
            w, flow = _lp.load_prop_plain_blocked(next_hop, load0, max_hops,
                                                  adaptive, tile)
        else:
            w, flow = _lp.load_prop_plain(next_hop, load0, max_hops,
                                          adaptive)
    else:
        raise ValueError(f"load_propagate runs on cuda or cpu, not {dev}")
    if squeeze:
        return w[0], flow[0]
    return w, flow


__all__ = ["load_propagate"]
