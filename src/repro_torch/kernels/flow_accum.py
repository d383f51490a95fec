"""Flow accumulation (the pair walk's per-hop scatter): the CUDA kernel, its
plain version and an emulation of the kernel's decomposition.

Port of ``src/repro/kernels/flow_accum.py`` as ``kernels.ops.flow_accumulate``
runs it:

    out[u, v] = flow[u, v] + Σ_p amount[p] · [cur[p] = u] · [nxt[p] = v]

* ``flow_accum_cuda`` — the hand-written Hopper kernels in
  ``csrc/flow_accum.cu``. They replace the TPU kernel
  ``src/repro/kernels/flow_accum.py:28`` (``_flow_kernel``, the scatter as
  a one-hot matmul): a stable counting sort of the pairs by row (per-chunk
  row histograms, an exclusive scan over (row, chunk), a scatter that ranks
  each pair among the earlier pairs of its row with ``__match_any_sync``),
  then one warp per row that adds the row's pairs in ascending p. No float
  atomics, so a cell's adds come in ascending p whatever the batch. Its
  bound is the bytes (flow, out, cur, nxt, amount); at one design the four
  launches set the time. ``launches`` counts its calls, one per hop.
* ``flow_accum_plain`` — ``ref.flow_accumulate_ref``, a scatter-add with
  ``index_add_``. On the CPU it adds in ascending p, so the kernel is
  bit-equal to it there; on a CUDA tensor ``index_add_`` adds with atomics
  in scheduling order, within float rounding of the kernel.
* ``flow_accum_emulated`` — the kernel's decomposition step by step in
  plain torch (histogram, scan, stable ranks 32 pairs at a time, the
  per-row walk). The tests hold it bit-equal to ``flow_accum_plain``;
  nothing on the main path calls it.

The reference padded the node axis to 128 lanes and the pair axis to its
block (``src/repro/kernels/ops.py:83-106``); neither is carried over.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import flow_accumulate_ref

SMEM_MAX = 232448             # the H100's per-block opt-in limit (227 KB)
WALK_WARPS = 4                # rows per block of the per-row walk
MAX_CHUNKS = 256              # pair chunks per design, at most


def smem_bytes(n: int) -> int:
    """Shared memory of the largest block at n nodes (mirrors the .cu
    file): the per-row walk keeps 4 rows of out and a 32-float stage per
    row, 16 (n + 32) bytes."""
    return WALK_WARPS * (n + 32) * 4


def pair_chunk(P: int) -> int:
    """Pairs per histogram/scatter chunk: 512, or more (a multiple of 32)
    so that a design has at most ``MAX_CHUNKS`` chunks."""
    return max(512, 32 * -(-P // (32 * MAX_CHUNKS)))


def scratch_ints(B: int, n: int, P: int) -> int:
    """int32 scratch of one launch: the offsets [B, n * n_chunks + 1] and
    the sorted (nxt, amount) pairs [B, P] each."""
    n_chunks = max(1, -(-P // pair_chunk(P)))
    return B * (n * n_chunks + 1) + 2 * B * P


# The plain version on any device: flow [B, n, n] float32; cur, nxt, amount
# [B, P].
flow_accum_plain = flow_accumulate_ref


def flow_accum_emulated(flow: torch.Tensor, cur: torch.Tensor,
                        nxt: torch.Tensor, amount: torch.Tensor,
                        chunk: int | None = None) -> torch.Tensor:
    """The CUDA kernels' decomposition in plain torch, for [B, n, n] flow and
    [B, P] pairs: (1) per-chunk row histograms of the live pairs, (2) an
    exclusive scan over (row, chunk) in row-major order, (3) each chunk's
    pairs ranked 32 at a time among the earlier pairs of their row (the
    match-any rank plus the row's running slot), (4) each row's sorted
    segment added into the row of out, 32 pairs at a time, each column's
    pairs in lane (= p) order. A pair whose cur or nxt lies outside [0, n)
    is dropped, as the kernel drops it."""
    B, n, _ = flow.shape
    P = cur.shape[1]
    chunk = pair_chunk(P) if chunk is None else chunk
    n_chunks = max(1, -(-P // chunk))
    cur, nxt = cur.long(), nxt.long()
    live = (cur >= 0) & (cur < n) & (nxt >= 0) & (nxt < n)
    p_chunk = torch.arange(P) // chunk
    # 1. histograms [B, n, n_chunks]
    counts = torch.zeros((B, n * n_chunks), dtype=torch.long)
    key = torch.where(live, cur * n_chunks + p_chunk, 0)
    counts.scatter_add_(1, key, live.long())
    # 2. exclusive scan over (row, chunk), the total in slot L
    flat = torch.cat([counts, torch.zeros((B, 1), dtype=torch.long)], 1)
    off = torch.cumsum(flat, 1) - flat
    # 3. stable ranks: per chunk, 32 pairs at a time
    slot = torch.full((B, P), -1, dtype=torch.long)
    lower = torch.ones((32, 32), dtype=torch.bool).tril(-1)   # [lane, j<lane]
    rows = torch.arange(n)
    for c in range(n_chunks):
        nxt_slot = off[:, rows * n_chunks + c].clone()          # [B, n]
        for p0 in range(c * chunk, min(P, (c + 1) * chunk), 32):
            p1 = min(P, p0 + 32)
            u, ok = cur[:, p0:p1], live[:, p0:p1]
            w = p1 - p0
            same = (u[:, :, None] == u[:, None, :]) & ok[:, :, None] \
                & ok[:, None, :]                                # peers
            rank = (same & lower[:w, :w]).sum(2)
            base = torch.gather(nxt_slot, 1, torch.where(ok, u, 0))
            slot[:, p0:p1] = torch.where(ok, base + rank, -1)
            add = torch.zeros_like(nxt_slot)
            add.scatter_add_(1, torch.where(ok, u, 0), ok.long())
            nxt_slot += add
    sorted_nxt = torch.zeros((B, P + 1), dtype=torch.long)
    sorted_amt = torch.zeros((B, P + 1), dtype=amount.dtype)
    dst = torch.where(slot >= 0, slot, P)                       # P: discard
    sorted_nxt.scatter_(1, dst, nxt)
    sorted_amt.scatter_(1, dst, amount)
    # 4. per-row walk: group g of every row at once, lanes in order
    start = off[:, rows * n_chunks]                             # [B, n]
    end = off[:, (rows + 1) * n_chunks]
    out = flow.clone()
    out_flat = out.view(B, n * n)
    longest = int((end - start).max()) if B * n else 0
    for g0 in range(0, longest, 32):
        for lane in range(32):
            k = start + g0 + lane                               # [B, n]
            ok = k < end
            kk = torch.where(ok, k, P)
            col = torch.where(ok, torch.gather(sorted_nxt, 1, kk), 0)
            amt = torch.where(ok, torch.gather(sorted_amt, 1, kk), 0.0)
            cell = rows[None, :] * n + col
            # one add per (design, row): distinct cells, in lane order
            cur_v = torch.gather(out_flat, 1, cell)
            out_flat.scatter_(1, cell, torch.where(ok, cur_v + amt, cur_v))
    return out


_SIGNATURES = {
    "flow_accum_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
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
        raise ValueError(f"flow_accum_cuda holds {WALK_WARPS} rows of n={n} "
                         f"in shared memory; {smem_bytes(n)} bytes exceed "
                         f"{SMEM_MAX}")
    out = torch.empty_like(flow)
    if B == 0 or n == 0:
        return out
    scratch = torch.empty(scratch_ints(B, n, P), dtype=torch.int32,
                          device=dev)
    lib = _lib()
    # at one design the host's launch is the whole cost: the raw stream
    # handle saves building a torch.cuda.Stream per hop
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with torch.cuda.device(dev):
        rc = lib.flow_accum_launch(flow.data_ptr(), cur.data_ptr(),
                                   nxt.data_ptr(), amount.data_ptr(),
                                   out.data_ptr(), scratch.data_ptr(), B, n,
                                   P, pair_chunk(P), stream)
    if rc != 0:
        msg = lib.flow_accum_error_string(rc).decode()
        raise RuntimeError(f"flow-accumulation kernel launch failed (cuda "
                           f"error {rc}: {msg}) at B={B}, n={n}, P={P}")
    flow_accum_cuda.launches += 1
    return out


flow_accum_cuda.launches = 0


__all__ = ["flow_accum_plain", "flow_accum_cuda", "flow_accum_emulated",
           "pair_chunk", "scratch_ints", "smem_bytes"]
