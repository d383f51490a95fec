"""Batched (min, +) matrix product: the CUDA kernel and its plain version.

Port of ``src/repro/kernels/minplus.py`` as ``kernels.ops.minplus_matmul``
runs it: ``out[i, j] = min(BIG, min_k a[i, k] + b[k, j])``. The TPU
kernel's scratch starts at BIG, so no entry ever comes out above BIG.

* ``minplus_cuda`` — the hand-written Hopper kernel in ``csrc/minplus.cu``.
  It replaces the TPU kernel ``src/repro/kernels/minplus.py:31``
  (``_minplus_kernel``): one thread block cluster per (design, output tile:
  64 x 64, or 32 x 32 where M or N is below 64) whose CTAs split k and
  merge their partial minima through distributed shared memory in rank
  order (``minplus_plan`` mirrors the launch's choice); k slices stream
  through a 3-stage ``cp.async`` ring; a 4 x 4 register block of the
  accumulator per thread; ragged edges masked in the kernel (no padding).
  It is bound by its operations, one add and one min per (i, k, j)
  candidate; the source note says what the design does about it.
  ``launches`` counts its calls.
* ``minplus_plain`` — ``minplus_ref``'s broadcast with the BIG ceiling,
  taken over row chunks so the transient stays bounded. Min is exact in
  any order, so the kernel and the plain version are bit-equal.

``kernels.ops.minplus_matmul`` picks between them by the tensor's device.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from .ref import BIG

_CHUNK_ELEMS = 1 << 25   # bound on the plain version's broadcast transient
# the kernel's launch plan (csrc/minplus.cu: kDepth, kMaxSplit, kFillCtas)
DEPTH, MAX_SPLIT, FILL_CTAS = 16, 8, 132


def minplus_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version on any device. a: [B, M, K], b: [B, K, N] float32.
    Returns [B, M, N] = min(BIG, min_k a + b)."""
    B, M, K = a.shape
    N = b.shape[-1]
    out = torch.full((B, M, N), BIG, dtype=torch.float32, device=a.device)
    if K == 0:
        return out
    rows = max(1, _CHUNK_ELEMS // max(1, B * K * N))
    for r0 in range(0, M, rows):
        cand = (a[:, r0:r0 + rows, :, None] + b[:, None, :, :]).amin(dim=2)
        out[:, r0:r0 + rows] = torch.minimum(out[:, r0:r0 + rows], cand)
    return out


def minplus_plan(B: int, M: int, K: int, N: int) -> dict:
    """The kernel's launch plan for [B, M, K] x [B, K, N] (mirrors ``plan``
    in ``csrc/minplus.cu``): a 64 x 64 output tile where M and N are both at
    least 64, else 32 x 32, with (tile / 4)^2 threads; k split over
    ``split`` CTAs of a cluster, doubled (up to 8) while the grid has fewer
    than 132 CTAs and each CTA would keep at least 16 k; CTA rank r takes
    k in [r k_per_cta, (r + 1) k_per_cta)."""
    tile = 64 if M >= 64 and N >= 64 else 32
    tiles = B * -(-M // tile) * -(-N // tile)
    split = 1
    while split < MAX_SPLIT and tiles * split < FILL_CTAS \
            and K >= 2 * split * DEPTH:
        split *= 2
    per = -(-K // split)
    return {"tile": tile, "threads": (tile // 4) ** 2, "split": split,
            "k_per_cta": -(-per // DEPTH) * DEPTH, "ctas": tiles * split}


_SIGNATURES = {
    "minplus_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "minplus_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib() -> ctypes.CDLL:
    from .build import library

    return library("minplus", _SIGNATURES)


def check_f32_cuda(what: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on one
    sm_90 CUDA device."""
    from .build import require_sm90

    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} takes float32 tensors, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")
    require_sm90(dev, what)


def launch_minplus(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor
                   ) -> bool:
    """One launch of the min-plus kernel into ``out`` (arguments checked by
    the callers); False when the output is empty and nothing launched.
    Raises if the launch fails."""
    B, M, K = a.shape
    N = b.shape[-1]
    if B == 0 or M == 0 or N == 0:
        return False
    lib = _lib()
    # the host's launch costs more than the kernel at the paths' shapes: the
    # raw stream handle saves building a torch.cuda.Stream per call, and the
    # device is switched only when the operands are not on the current one
    stream = torch._C._cuda_getCurrentRawStream(a.device.index)
    current = a.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(a.device):
        rc = lib.minplus_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                B, M, K, N, stream)
    if rc != 0:
        msg = lib.minplus_error_string(rc).decode()
        raise RuntimeError(f"min-plus kernel launch failed (cuda error "
                           f"{rc}: {msg}) at B={B}, M={M}, K={K}, N={N}")
    return True


def minplus_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream. a: [B, M, K],
    b: [B, K, N], contiguous float32 on one CUDA device. Returns
    [B, M, N]; raises if the launch fails."""
    check_f32_cuda("minplus_cuda", a, b)
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"minplus_cuda takes [B, M, K] x [B, K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    out = torch.empty((a.shape[0], a.shape[1], b.shape[2]),
                      dtype=torch.float32, device=a.device)
    if launch_minplus(a, b, out):
        minplus_cuda.launches += 1
    return out


minplus_cuda.launches = 0


__all__ = ["minplus_plain", "minplus_cuda", "minplus_plan", "check_f32_cuda",
           "launch_minplus"]
