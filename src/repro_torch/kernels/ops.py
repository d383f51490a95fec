"""Public entry of the port's kernels (port of ``src/repro/kernels/ops.py``:
``minplus_matmul``, ``apsp``, ``load_propagate`` and ``flow_accumulate``;
``selective_scan`` is the route the reference's ``models/ssm.py`` took to
its kernel).

The route follows the tensor's device and nothing else: a CUDA tensor
launches the hand-written kernel or raises, and only a CPU tensor takes the
plain PyTorch version. There is no fallback from one to the other, and no
backend knob: the reference's ``REPRO_APSP_BACKEND`` and its fallback
ladder are not ported. The scan alone also takes a meta tensor (the
dry-run's shape-only trace): it returns outputs of the kernel's shapes and
does no work, as the reference's Pallas call lowers to one opaque op.
"""
from __future__ import annotations

import math

import torch

from ..utils import env as _env
from . import apsp as _apsp
from . import flow_accum as _fa
from . import load_prop as _lp
from . import minplus as _mp
from . import selective_scan as _ss
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
    fused form runs: on CUDA ``apsp.apsp_fused_cuda`` (a CTA cluster a design);
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


def flow_accumulate(flow: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor,
                    amount: torch.Tensor) -> torch.Tensor:
    """Scatter of per-pair traffic onto directed edges, for [n, n] or
    batched [B, n, n] flow with cur, nxt, amount [P] or [B, P]:

        out[u, v] = flow[u, v] + Σ_p amount[p] · [cur[p] = u] · [nxt[p] = v]

    On CUDA: ``flow_accum.flow_accum_cuda`` (adds in ascending p, no
    atomics). On the CPU: ``flow_accum.flow_accum_plain`` (``index_add_``,
    also ascending p), so the two give the same bits.
    """
    squeeze = flow.dim() == 2
    if squeeze:
        flow, cur, nxt, amount = flow[None], cur[None], nxt[None], amount[None]
    flow = flow.to(torch.float32).contiguous()
    cur = cur.to(torch.int32).contiguous()
    nxt = nxt.to(torch.int32).contiguous()
    amount = amount.to(torch.float32).contiguous()
    if _device_type(flow, cur, nxt, amount) == "cuda":
        out = _fa.flow_accum_cuda(flow, cur, nxt, amount)
    else:
        out = _fa.flow_accum_plain(flow, cur, nxt, amount)
    return out[0] if squeeze else out


def selective_scan_fwd(xc, dt, bm, cm, a, h0, *, chunk: int = 256):
    """Forward pass, routed by device. xc, dt: [B, S, Di]; bm, cm:
    [B, S, N]; a: [Di, N]; h0: [B, Di, N], all float32. Returns (y
    [B, S, Di], h_ckpt [B, S/chunk, Di, N], hT [B, Di, N])."""
    if xc.device.type == "meta":
        b, s, di = xc.shape
        out = lambda *shape: torch.empty(shape, device="meta")
        return (out(b, s, di), out(b, s // chunk, di, a.shape[1]),
                out(b, di, a.shape[1]))
    args = [t.contiguous() for t in (xc, dt, bm, cm, a, h0)]
    if _device_type(*args) == "cuda":
        return _ss.selective_scan_fwd_cuda(*args, chunk=chunk)
    return _ss.selective_scan_fwd_plain(*args, chunk=chunk)


def selective_scan_bwd(xc, dt, bm, cm, a, h_ckpt, dy, *, chunk: int = 256):
    """Backward pass, routed by device. Returns (dxc, ddt, dbm, dcm, da,
    dh0); da is summed over the batch."""
    if xc.device.type == "meta":
        b, _, di = xc.shape
        return (torch.empty_like(xc), torch.empty_like(dt),
                torch.empty_like(bm), torch.empty_like(cm),
                torch.empty_like(a), torch.empty((b, di, a.shape[1]),
                                                 device="meta"))
    args = [t.contiguous() for t in (xc, dt, bm, cm, a, h_ckpt, dy)]
    if _device_type(*args) == "cuda":
        return _ss.selective_scan_bwd_cuda(*args, chunk=chunk)
    return _ss.selective_scan_bwd_plain(*args, chunk=chunk)


class SelectiveScan(torch.autograd.Function):
    """y = selective_scan(xc, dt, bm, cm, a, h0, chunk): the forward kernel
    saves its chunk checkpoints, the backward kernel re-runs from them
    (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, xc, dt, bm, cm, a, h0, chunk):
        y, ckpt, _ = selective_scan_fwd(xc, dt, bm, cm, a, h0, chunk=chunk)
        ctx.save_for_backward(xc, dt, bm, cm, a, ckpt)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        xc, dt, bm, cm, a, ckpt = ctx.saved_tensors
        grads = selective_scan_bwd(xc, dt, bm, cm, a, ckpt, dy,
                                   chunk=ctx.chunk)
        return (*grads, None)


def selective_scan(xc, dt, bm, cm, a, h0, chunk: int = 256) -> torch.Tensor:
    """y [B, S, Di] of the scan, differentiable in every tensor argument."""
    return SelectiveScan.apply(xc, dt, bm, cm, a, h0, chunk)


__all__ = ["minplus_matmul", "apsp", "apsp_iters", "load_propagate",
           "flow_accumulate", "selective_scan", "selective_scan_fwd",
           "selective_scan_bwd", "SelectiveScan"]
