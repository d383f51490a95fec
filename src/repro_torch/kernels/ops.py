"""Public entry of the port's kernels (port of ``src/repro/kernels/ops.py``:
``minplus_matmul``, ``apsp`` and ``load_propagate``; ``flow_accumulate``
waits for its kernel).

The route follows the tensor's device and nothing else: a CUDA tensor
launches the hand-written kernel or raises, and only a CPU tensor takes the
plain PyTorch version. There is no fallback from one to the other, and no
backend knob: the reference's ``REPRO_APSP_BACKEND`` and its fallback
ladder are not ported.
"""
from __future__ import annotations

import math

import torch

from ..utils import env as _env
from . import apsp as _apsp
from . import load_prop as _lp
from . import minplus as _mp
from .ref import BIG


def _device_type(*tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port's kernels run on cuda or cpu, not "
                         f"{dev.type}")
    return dev.type


def minplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(min, +) product for [M, K] x [K, N] or batched [B, M, K] x
    [B, K, N] inputs: ``out[i, j] = min(BIG, min_k a[i, k] + b[k, j])``.

    On CUDA: ``minplus.minplus_cuda`` (ragged edges masked in the kernel,
    no padding). On the CPU: ``minplus.minplus_plain``. Both are bit-equal
    to the reference's BIG-padded kernel.
    """
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    a = a.to(torch.float32).contiguous()
    b = b.to(torch.float32).contiguous()
    if _device_type(a, b) == "cuda":
        out = _mp.minplus_cuda(a, b)
    else:
        out = _mp.minplus_plain(a, b)
    return out[0] if squeeze else out


def apsp_iters(n: int) -> int:
    """Squarings after which every path of length <= n - 1 has converged."""
    return max(1, math.ceil(math.log2(max(n - 1, 2))) + 1)


def apsp(d: torch.Tensor, n_iters: int | None = None) -> torch.Tensor:
    """All-pairs path costs by min-plus squaring. d: [n, n] or [B, n, n]
    step costs (+inf/BIG = no edge; the diagonal is forced to 0). Returns
    float32 costs with +inf where unreachable (BIG / 2 and above).

    Up to ``REPRO_APSP_FUSED_N`` (default 160) nodes, and at most
    ``apsp.MAX_FUSED_N`` (what the fused kernel's shared memory holds), the
    fused form runs: on CUDA ``apsp.apsp_fused_cuda`` (one CTA per design);
    on the CPU ``apsp.apsp_plain``. Above it, one tiled squaring per step,
    which is iterated min-plus: on CUDA ``apsp.apsp_square_cuda`` (the
    min-plus kernel applied to (m, m)); on the CPU
    ``apsp.apsp_plain_blocked`` with the tile from ``REPRO_APSP_TILE`` or
    ``load_prop.pick_tile``. All forms give the same bits.
    """
    squeeze = d.dim() == 2
    if squeeze:
        d = d[None]
    B, n, _ = d.shape
    if n_iters is None:
        n_iters = apsp_iters(n)
    on_cuda = _device_type(d) == "cuda"
    d = d.to(torch.float32)
    d = torch.clamp_max(torch.where(torch.isfinite(d), d, BIG), BIG)
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    d = torch.minimum(d, torch.where(eye, 0.0, BIG)).contiguous()
    if n > min(_env.get_int("REPRO_APSP_FUSED_N"), _apsp.MAX_FUSED_N):
        if on_cuda:
            out = _apsp.apsp_square_cuda(d, n_iters)
        else:
            tile = (_env.get_opt_int("REPRO_APSP_TILE")
                    or _lp.pick_tile(n, B))
            out = _apsp.apsp_plain_blocked(d, n_iters, tile)
    else:
        out = (_apsp.apsp_fused_cuda(d, n_iters) if on_cuda
               else _apsp.apsp_plain(d, n_iters))
    out = torch.where(out >= BIG * 0.5, torch.inf, out)
    return out[0] if squeeze else out


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


__all__ = ["minplus_matmul", "apsp", "apsp_iters", "load_propagate"]
