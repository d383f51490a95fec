"""Flow accumulation (the pair walk's per-hop scatter): the CUDA kernel and
its plain version.

Port of ``src/repro/kernels/flow_accum.py`` as ``kernels.ops.flow_accumulate``
runs it:

    out[u, v] = flow[u, v] + Σ_p amount[p] · [cur[p] = u] · [nxt[p] = v]

* ``flow_accum_cuda`` — the hand-written Hopper kernel in
  ``csrc/flow_accum.cu``. It replaces the TPU kernel
  ``src/repro/kernels/flow_accum.py:28`` (``_flow_kernel``, the scatter as
  a one-hot matmul): one warp per (design, 32 rows of out), each lane
  owning a row accumulated in shared memory; the pairs are staged in
  ascending p and a ballot over each 32 picks the warp's rows, added in
  lane order by the owning lane. No atomics, so a cell's adds come in
  ascending p whatever the batch. Its bound is the bytes (flow, out, cur,
  nxt, amount); the source note says why the scan over all pairs, not the
  bytes, limits it. ``launches`` counts its calls.
* ``flow_accum_plain`` — ``ref.flow_accumulate_ref``, a scatter-add with
  ``index_add_``. On the CPU it adds in ascending p, so the kernel is
  bit-equal to it there; on a CUDA tensor ``index_add_`` adds with atomics
  in scheduling order, within float rounding of the kernel.

The reference padded the node axis to 128 lanes and the pair axis to its
block (``src/repro/kernels/ops.py:83-106``); neither is carried over.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import flow_accumulate_ref

SMEM_MAX = 232448             # the H100's per-block opt-in limit (227 KB)


def smem_bytes(n: int) -> int:
    """Shared memory of one block at n nodes (mirrors the .cu file): 32 rows
    of out and 1024 staged pairs."""
    return 32 * n * 4 + 3 * 1024 * 4


# The plain version on any device: flow [B, n, n] float32; cur, nxt, amount
# [B, P].
flow_accum_plain = flow_accumulate_ref


_SIGNATURES = {
    "flow_accum_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "flow_accum_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib() -> ctypes.CDLL:
    from .build import library

    return library("flow_accum", _SIGNATURES)


def flow_accum_cuda(flow: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor,
                    amount: torch.Tensor) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream. flow: [B, n, n]
    contiguous float32; cur, nxt: [B, P] contiguous int32; amount: [B, P]
    contiguous float32; all on one CUDA device. Returns a new [B, n, n];
    raises if the arguments or the launch fail. A pair whose cur or nxt lies
    outside [0, n) adds nothing (the kernel checks it; checking here would
    cost a host sync per hop), where the plain version raises."""
    from .build import require_sm90

    tensors = (flow, cur, nxt, amount)
    dev = flow.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"flow_accum_cuda needs its tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if flow.dtype != torch.float32 or amount.dtype != torch.float32 \
            or cur.dtype != torch.int32 or nxt.dtype != torch.int32:
        raise TypeError(f"flow_accum_cuda takes float32 flow/amount and int32 "
                        f"cur/nxt, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flow_accum_cuda takes contiguous tensors")
    if flow.dim() != 3 or flow.shape[1] != flow.shape[2] or any(
            t.dim() != 2 or t.shape != cur.shape for t in (nxt, amount)) \
            or cur.dim() != 2 or cur.shape[0] != flow.shape[0]:
        raise ValueError(f"flow_accum_cuda takes flow [B, n, n] and cur, nxt, "
                         f"amount [B, P], got {[tuple(t.shape) for t in tensors]}")
    require_sm90(dev, "flow_accum_cuda")
    B, n, _ = flow.shape
    P = cur.shape[1]
    if smem_bytes(n) > SMEM_MAX:
        raise ValueError(f"flow_accum_cuda holds 32 rows of n={n} in shared "
                         f"memory; {smem_bytes(n)} bytes exceed {SMEM_MAX}")
    out = torch.empty_like(flow)
    if B == 0 or n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        rc = lib.flow_accum_launch(flow.data_ptr(), cur.data_ptr(),
                                   nxt.data_ptr(), amount.data_ptr(),
                                   out.data_ptr(), B, n, P, stream.cuda_stream)
    if rc != 0:
        msg = lib.flow_accum_error_string(rc).decode()
        raise RuntimeError(f"flow-accumulation kernel launch failed (cuda "
                           f"error {rc}: {msg}) at B={B}, n={n}, P={P}")
    flow_accum_cuda.launches += 1
    return out


flow_accum_cuda.launches = 0


__all__ = ["flow_accum_plain", "flow_accum_cuda"]
