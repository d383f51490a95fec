"""All-pairs shortest paths by min-plus squaring: the CUDA kernels and their
plain versions.

Port of ``src/repro/kernels/apsp.py``. The input is a [B, n, n] float32
step-cost stack with BIG (1e18) for "no edge" and a zeroed diagonal
(``kernels.ops.apsp`` prepares it); ``n_iters`` squarings later every entry
is the cheapest path cost. Every candidate is one f32 add and min is exact,
so every form here gives the same bits.

* ``apsp_fused_cuda`` — the hand-written Hopper kernel in ``csrc/apsp.cu``.
  It replaces the TPU kernel ``src/repro/kernels/apsp.py:71``
  (``_apsp_kernel``): one thread block cluster per design
  (``fused_plan``), whose CTAs each hold the current and the next iterate
  in shared memory, compute the band of rows they own and store it into
  every CTA's next iterate (distributed shared memory); a design stops
  once a squaring leaves its bits unchanged (its fixed point, so the
  result equals all ``n_iters`` squarings'). It takes n <= ``MAX_FUSED_N``.
  Bound by its operations (one add and one min per candidate, B n_iters
  n^3 candidates, counted in full whatever the early stop saves).
* ``apsp_square_cuda`` — one blocked squaring per launch, ping-ponging two
  device buffers. It replaces the TPU kernel ``apsp.py:167``
  (``_apsp_square_kernel``) with ``csrc/minplus.cu``'s kernel applied to
  (m, m): with a zero diagonal ``minplus(m, m) <= m`` entry by entry, so
  the squaring needs no minimum with its input. ``launches`` counts each
  squaring launch.
* ``apsp_plain`` — a transcription of ``apsp_xla``: ``m = min(m, min_k
  m[:, k] + m[k, :])``, each product by ``minplus.minplus_plain``.
* ``apsp_plain_blocked`` — a transcription of ``apsp_xla_blocked``:
  [tile, n] row slabs with an inner k-slab scan, BIG-padded to a multiple
  of the tile (cropped on return).

``kernels.ops.apsp`` picks among them by the tensor's device and n.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from .minplus import check_f32_cuda, launch_minplus, minplus_plain
from .ref import BIG

SMEM_MAX = 232448          # the H100's per-block opt-in shared memory
# the fused route's limit: two f32 [n, n] panes fit in SMEM_MAX up to here
MAX_FUSED_N = 170
THREADS, MAX_CLUSTER = 256, 8      # csrc/apsp.cu kThreads, kMaxCluster


def fused_plan(n: int) -> dict:
    """The fused kernel's launch at n (mirrors ``apsp_fused_launch``): a
    cluster of the smallest power of two >= n / 8 CTAs (at most 8), each
    owning ``band`` rows; an MI x W register block a thread (1 x 2 where a
    band has at most 512 entries, else 2 x 4, or 2 x 2 where 4-float rows
    would not fit); rows padded to ``ld`` floats; shared memory for two
    [n, ld] panes and 2 x 8 int flags. It depends on n only."""
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * 8 < n:
        cluster *= 2
    band = -(-n // cluster)
    smem = lambda ld: 8 * n * ld + 4 * 2 * MAX_CLUSTER
    mi, w = (1, 2) if band * n <= 2 * THREADS else (2, 4)
    if w == 4 and smem(-(-n // 4) * 4) > SMEM_MAX:
        w = 2
    ld = -(-n // w) * w
    return {"cluster": cluster, "band": band, "ld": ld, "mi": mi, "w": w,
            "smem": smem(ld)}


def apsp_plain(d: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Plain fused form on any device. d: [B, n, n] float32 (BIG = no edge,
    zero diagonal). Entries never exceed BIG, so the product's BIG ceiling
    changes nothing."""
    m = d
    for _ in range(n_iters):
        m = torch.minimum(m, minplus_plain(m, m))
    return m


def apsp_plain_blocked(d: torch.Tensor, n_iters: int, tile: int
                       ) -> torch.Tensor:
    """Plain blocked form: each squaring scans [tile, n] row slabs with an
    inner k-slab scan, so the transient is [B, tile, tile, n]; a tile that
    does not divide n gets a BIG-padded ragged edge (cropped on return)."""
    B, n, _ = d.shape
    tile = max(1, min(tile, n))
    nt = -(-n // tile)
    n_pad = nt * tile
    m = d
    if n_pad != n:
        m = torch.full((B, n_pad, n_pad), BIG, dtype=d.dtype, device=d.device)
        m[:, :n, :n] = d
    for _ in range(n_iters):
        nxt = torch.empty_like(m)
        for i in range(nt):
            a = m[:, i * tile:(i + 1) * tile]                    # [B, T, n]
            acc = torch.full_like(a, BIG)
            for k in range(nt):
                ak = a[:, :, k * tile:(k + 1) * tile]
                bk = m[:, k * tile:(k + 1) * tile]
                cand = (ak[:, :, :, None] + bk[:, None, :, :]).amin(dim=2)
                acc = torch.minimum(acc, cand)
            nxt[:, i * tile:(i + 1) * tile] = acc
        m = nxt
    return m[:, :n, :n]


_SIGNATURES = {
    "apsp_fused_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "apsp_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib() -> ctypes.CDLL:
    from .build import library

    return library("apsp", _SIGNATURES)


def _check(what: str, d: torch.Tensor, n_iters: int) -> None:
    check_f32_cuda(what, d)
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"{what} takes a [B, n, n] tensor, got "
                         f"{tuple(d.shape)}")
    if n_iters < 0:
        raise ValueError(f"n_iters={n_iters} must be >= 0")


def apsp_fused_cuda(d: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Launch the fused Hopper kernel on the current stream: ``n_iters``
    (min, +) squarings of each design, or fewer where a design reaches its
    fixed point first (the same bits). d: [B, n, n] contiguous float32 on a
    CUDA device with a zero diagonal and BIG for "no edge", n <=
    MAX_FUSED_N. Each design runs on a cluster of ``fused_plan(n)
    ["cluster"]`` CTAs, chosen from n only, so a design gives the same bits
    alone or in a batch. Raises if the launch fails."""
    _check("apsp_fused_cuda", d, n_iters)
    B, n, _ = d.shape
    if n > MAX_FUSED_N:
        raise ValueError(f"apsp_fused_cuda takes n <= {MAX_FUSED_N} (the "
                         f"fused route's limit), got n={n}")
    out = torch.empty_like(d)
    if B == 0 or n == 0:
        return out
    lib = _lib()
    # as in minplus.launch_minplus: the raw stream handle, and a device
    # switch only when the operand is not on the current device
    stream = torch._C._cuda_getCurrentRawStream(d.device.index)
    current = d.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(d.device):
        rc = lib.apsp_fused_launch(d.data_ptr(), out.data_ptr(), B, n,
                                   n_iters, stream)
    if rc != 0:
        msg = lib.apsp_error_string(rc).decode()
        raise RuntimeError(f"fused APSP kernel launch failed (cuda error "
                           f"{rc}: {msg}) at B={B}, n={n}")
    apsp_fused_cuda.launches += 1
    return out


apsp_fused_cuda.launches = 0


def apsp_square_cuda(d: torch.Tensor, n_iters: int) -> torch.Tensor:
    """``n_iters`` tiled squarings on the current stream, one min-plus
    kernel launch each, between two device buffers. d: [B, n, n] contiguous
    float32 on a CUDA device with a zero diagonal. Raises if a launch
    fails."""
    _check("apsp_square_cuda", d, n_iters)
    if n_iters == 0:
        return d.clone()
    bufs = (torch.empty_like(d), torch.empty_like(d))
    src = d
    for i in range(n_iters):
        if launch_minplus(src, src, bufs[i % 2]):
            apsp_square_cuda.launches += 1
        src = bufs[i % 2]
    return src


apsp_square_cuda.launches = 0


__all__ = ["MAX_FUSED_N", "fused_plan", "apsp_plain", "apsp_plain_blocked",
           "apsp_fused_cuda", "apsp_square_cuda"]
