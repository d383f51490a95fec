"""All-pairs shortest paths by min-plus squaring: the CUDA kernels and their
plain versions.

Port of ``src/repro/kernels/apsp.py``. The input is a [B, n, n] float32
step-cost stack with BIG (1e18) for "no edge" and a zeroed diagonal
(``kernels.ops.apsp`` prepares it); ``n_iters`` squarings later every entry
is the cheapest path cost. Every candidate is one f32 add and min is exact,
so every form here gives the same bits.

* ``apsp_fused_cuda`` — the hand-written Hopper kernel in ``csrc/apsp.cu``.
  It replaces the TPU kernel ``src/repro/kernels/apsp.py:71``
  (``_apsp_kernel``): one CTA per design keeps the previous and the next
  iterate as two [n, n] panes in shared memory for all ``n_iters``
  squarings, so it takes n <= ``MAX_FUSED_N`` (170: two f32 panes in a
  block's 232,448 bytes). Bound by its operations (one add and one min per
  candidate, B n_iters n^3 candidates).
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

import ctypes

import torch

from .minplus import check_f32_cuda, launch_minplus, minplus_plain
from .ref import BIG

SMEM_MAX = 232448          # the H100's per-block opt-in shared memory
MAX_FUSED_N = 170          # two f32 [n, n] panes fit in SMEM_MAX up to here


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
    """Launch the fused Hopper kernel on the current stream. d: [B, n, n]
    contiguous float32 on a CUDA device, n <= MAX_FUSED_N. Raises if the
    launch fails."""
    _check("apsp_fused_cuda", d, n_iters)
    B, n, _ = d.shape
    if n > MAX_FUSED_N:
        raise ValueError(f"apsp_fused_cuda takes n <= {MAX_FUSED_N} (two "
                         f"[n, n] panes in shared memory), got n={n}")
    out = torch.empty_like(d)
    if B == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(d.device)
    with torch.cuda.device(d.device):
        rc = lib.apsp_fused_launch(d.data_ptr(), out.data_ptr(), B, n,
                                   n_iters, stream.cuda_stream)
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


__all__ = ["MAX_FUSED_N", "apsp_plain", "apsp_plain_blocked",
           "apsp_fused_cuda", "apsp_square_cuda"]
