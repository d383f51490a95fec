"""Per-destination load propagation: the CUDA kernel and its plain version.

Port of ``src/repro/kernels/load_prop.py``. The state L[d, u] (traffic at u
bound for d) moves one hop per step through the static routing table; the
per-hop loads are summed into W = Σ_j L_j, and the directed edge flows fall
out of W in one contraction:

    L'[d, v]   = Σ_u [next_hop[u, d] = v] · L[d, u]     (L'[d, d] = 0)
    W[d, u]    = Σ_{j < max_hops} L_j[d, u]
    flow[u, v] = Σ_d [next_hop[u, d] = v] · W[d, u]

Three forms live here:

* ``load_prop_cuda`` — the hand-written Hopper kernel pair in
  ``csrc/load_prop.cu``. It replaces the TPU kernels
  ``src/repro/kernels/load_prop.py:144`` (``_load_prop_kernel``) and
  ``:279`` (``_load_prop_tiled_kernel``) with one pair for every n. The hop
  kernel runs one CTA per (design, ``cuda_tile(n)`` destination rows) and
  one warp per row: the warp inverts its row's table column into
  predecessor lists (each index ranked among its peers, ascending u),
  keeps the row's L in shared memory and, up to n = 256, its own values'
  ranges, L and W in registers, sums each L'[d, v] over v's predecessors
  in ascending u (no float atomics), and stops once the row's load is all
  zero. The flow kernel runs one warp per source row u on the finished W
  and sums each flow[u, v] in ascending d. Both orders are the first
  design's, so W and flow are bit-equal to it. Its bound
  on the H100 is the bytes of next_hop, load0, W and flow (16 B n² per
  design); the source note in the ``.cu`` file says what the design does
  about it. ``launches`` counts its calls.
* ``load_prop_plain`` — a transcription of ``load_prop_xla``: the one-hot
  OH[d, u, v] = [next_hop[u, d] = v] built once, one batched contraction per
  hop. The CPU path for n ≤ ``REPRO_LOAD_PROP_FUSED_N``.
* ``load_prop_plain_blocked`` — a transcription of
  ``load_prop_xla_blocked``: the same over ``tile``-row destination slabs,
  so the transient one-hot is [B, tile, n, n]. The CPU path above
  ``REPRO_LOAD_PROP_FUSED_N``; with ``tile=cuda_tile(n)`` it runs the
  kernel's slab decomposition, ragged last slab included. Its flow adds
  fixed ``FLOW_GROUP``-row terms in d order, so a design's bits do not
  depend on the tile, which ``pick_tile`` picks from the batch.

On the CPU both plain forms run one design at a time
(``_one_design_at_a_time``): there the one-hot contractions of a lone
design reduce in another order than the batched ones (for n ≥ 32 a design
alone got other W and flow bits than in a batch), and they run faster. So
a design's bits do not depend on the batch size, down to a population
shard of one row. On a CUDA tensor, where the plain forms only check the
kernel, they stay batched.

``kernels.ops.load_propagate`` picks among them by the tensor's device: a
CUDA tensor launches the kernel or raises; only a CPU tensor takes a plain
form.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

SMEM_DEFAULT = 48 * 1024      # bytes a block may use without opting in
SMEM_MAX = 232448             # the H100's per-block opt-in limit (227 KB)
MAX_SLAB_ROWS = 8             # csrc/load_prop.cu kWarps: one warp a row
FLOW_GROUP = 8                # destination rows a flow term of the slab form


def _hops_smem(n: int, tile: int) -> int:
    """Shared memory of one CTA of either kernel at ``tile`` rows (mirrors
    ``row_smem_bytes`` in the .cu file): per row three f32 rows (L, L' and
    W; the flow kernel's staged W column and key row), the uint32 list
    ranges and the uint16 list."""
    return tile * 18 * n


def cuda_tile(n: int) -> int:
    """Destination rows per CTA of the hop kernel, one warp each: 8, or
    fewer where n is smaller or 8 rows would not fit in a block's shared
    memory (above 48 KB the launch opts in). It depends on n only, never on
    the batch, so a design's bits do not depend on its batch-mates."""
    if n > 65535 or _hops_smem(n, 1) > SMEM_MAX:
        raise ValueError(f"n={n} exceeds the load-propagation kernel's "
                         f"shared-memory limit")
    return max(1, min(MAX_SLAB_ROWS, n, SMEM_MAX // _hops_smem(n, 1)))


def cuda_flow_rows(n: int) -> int:
    """Source rows per CTA of the flow kernel, one warp each (the same
    per-row layout as the hop kernel's, so the same count)."""
    return cuda_tile(n)


def cuda_plan(n: int, batch: int) -> dict:
    """The launch of ``load_prop_cuda`` at [batch, n, n] (mirrors
    ``load_prop_launch``): rows a CTA (one warp each), CTAs and
    shared-memory bytes a CTA, for both kernels, and the values a lane of
    the hop kernel keeps in registers (``hop_vpl``; 0 above n = 256, where
    they stay in shared memory)."""
    tile, rows = cuda_tile(n), cuda_flow_rows(n)
    vpl = next((v for v in (1, 2, 4, 8) if 32 * v >= n), 0)
    return {"tile": tile, "hop_vpl": vpl, "hop_ctas": batch * -(-n // tile),
            "hop_threads": 32 * tile, "hop_smem": _hops_smem(n, tile),
            "flow_rows": rows, "flow_ctas": batch * -(-n // rows),
            "flow_threads": 32 * rows, "flow_smem": _hops_smem(n, rows)}


def pick_tile(n: int, batch: int, budget_elems: int = 1 << 25) -> int:
    """Tile of the plain slab form: the largest power of two ≤ 128 whose
    one-hot transient (batch · tile · n² elements) stays under
    ``budget_elems`` (copy of the reference's rule, floor 8)."""
    tile = 128
    while tile > 8 and batch * tile * n * n > budget_elems:
        tile //= 2
    return tile


def _hop_loop(step, load, total, max_hops: int, adaptive: bool):
    """``max_hops`` steps of ``(load, total) -> (load, total)``; with
    ``adaptive`` it stops once no load is left (the remaining steps would
    add exact zeros)."""
    for _ in range(max_hops):
        if adaptive and not bool((load > 0).any()):
            break
        load, total = step(load, total)
    return load, total


def _one_design_at_a_time(form):
    """On the CPU, run ``form`` on each design of the batch alone and stack
    the results: the contractions of one design, whatever the batch
    size."""
    @functools.wraps(form)
    def run(next_hop, load0, *args, **kw):
        if next_hop.shape[0] <= 1 or next_hop.device.type != "cpu":
            return form(next_hop, load0, *args, **kw)
        w, flow = zip(*(form(nh[None], l0[None], *args, **kw)
                        for nh, l0 in zip(next_hop, load0)))
        return torch.cat(w), torch.cat(flow)

    return run


@_one_design_at_a_time
def load_prop_plain(next_hop: torch.Tensor, load0: torch.Tensor,
                    max_hops: int, adaptive: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense plain version on any device. next_hop: [B, n, n] int
    (src-major); load0: [B, n, n] f32 dest-major. Returns (W, flow)."""
    B, n, _ = next_hop.shape
    dev = next_hop.device
    ids = torch.arange(n, device=dev)
    offdiag = ~torch.eye(n, dtype=torch.bool, device=dev)
    nhT = next_hop.transpose(-1, -2).long()                      # [B, d, u]
    oh = (nhT[..., None] == ids).to(torch.float32)               # [B, d, u, v]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    load = torch.where(offdiag, load0.to(torch.float32), zero)

    def step(load, total):
        total = total + load
        load = torch.where(offdiag,
                           torch.einsum("bduv,bdu->bdv", oh, load), zero)
        return load, total

    _, total = _hop_loop(step, load, torch.zeros_like(load), max_hops,
                         adaptive)
    flow = torch.einsum("bduv,bdu->buv", oh, total)
    return total, flow


@_one_design_at_a_time
def load_prop_plain_blocked(next_hop: torch.Tensor, load0: torch.Tensor,
                            max_hops: int, adaptive: bool, tile: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain slab form: each ``tile``-row destination slab runs its own hop
    loop (an adaptive slab stops at its own eccentricity) and adds its part
    of ``flow``; the last slab may be ragged."""
    B, n, _ = next_hop.shape
    dev = next_hop.device
    tile = max(1, min(tile, n))
    ids = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nhT = next_hop.transpose(-1, -2).long()                      # [B, d, u]
    l0 = load0.to(torch.float32)
    w = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    flow = torch.zeros((B, n, n), dtype=torch.float32, device=dev)
    for d0 in range(0, n, tile):
        d1 = min(d0 + tile, n)
        oh = (nhT[:, d0:d1, :, None] == ids).to(torch.float32)  # [B, T, u, v]
        offdiag = torch.arange(d0, d1, device=dev)[:, None] != ids  # [T, v]
        load = torch.where(offdiag, l0[:, d0:d1], zero)

        def step(load, total, oh=oh, offdiag=offdiag):
            total = total + load
            load = torch.where(offdiag,
                               torch.einsum("btuv,btu->btv", oh, load), zero)
            return load, total

        _, total = _hop_loop(step, load, torch.zeros_like(load), max_hops,
                             adaptive)
        w[:, d0:d1] = total
        # flow in fixed FLOW_GROUP-row groups of destinations, added in d
        # order: the sum's order, and so its bits, do not depend on the
        # tile (pick_tile picks it from the batch) for any tile that is a
        # multiple of FLOW_GROUP, as pick_tile's always are
        cuts = [d0] + list(range(d0 - d0 % FLOW_GROUP + FLOW_GROUP, d1,
                                 FLOW_GROUP)) + [d1]
        for s0, s1 in zip(cuts[:-1], cuts[1:]):
            flow = flow + torch.einsum("btuv,btu->buv",
                                       oh[:, s0 - d0:s1 - d0],
                                       total[:, s0 - d0:s1 - d0])
    return w, flow


_SIGNATURES = {
    "load_prop_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "load_prop_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _lib() -> ctypes.CDLL:
    from .build import library

    return library("load_prop", _SIGNATURES)


def _check_cuda_args(next_hop: torch.Tensor, load0: torch.Tensor,
                     max_hops: int) -> None:
    if next_hop.device.type != "cuda" or load0.device != next_hop.device:
        raise ValueError(f"load_prop_cuda needs both tensors on one CUDA "
                         f"device, got {next_hop.device} and {load0.device}")
    if next_hop.dtype != torch.int32 or load0.dtype != torch.float32:
        raise TypeError(f"load_prop_cuda takes int32 next_hop and float32 "
                        f"load0, got {next_hop.dtype} and {load0.dtype}")
    if (next_hop.dim() != 3 or next_hop.shape[1] != next_hop.shape[2]
            or load0.shape != next_hop.shape):
        raise ValueError(f"load_prop_cuda takes matching [B, n, n] tensors, "
                         f"got {tuple(next_hop.shape)} and "
                         f"{tuple(load0.shape)}")
    if not (next_hop.is_contiguous() and load0.is_contiguous()):
        raise ValueError("load_prop_cuda takes contiguous tensors")
    if max_hops < 0:
        raise ValueError(f"max_hops={max_hops} must be >= 0")
    from .build import require_sm90

    require_sm90(next_hop.device, "the load-propagation kernel")


def load_prop_cuda(next_hop: torch.Tensor, load0: torch.Tensor,
                   max_hops: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the Hopper kernel pair on the current stream. next_hop:
    [B, n, n] int32, load0: [B, n, n] float32, both contiguous on one CUDA
    device. Returns (W, flow); raises if the launch fails."""
    _check_cuda_args(next_hop, load0, max_hops)
    B, n, _ = next_hop.shape
    w, flow = torch.empty((2, B, n, n), dtype=torch.float32,
                          device=load0.device).unbind(0)   # one allocation
    if B == 0:
        return w, flow
    tile, rows = cuda_tile(n), cuda_flow_rows(n)
    lib = _lib()
    # as in minplus.launch_minplus: the raw stream handle, and a device
    # switch only when the operands are not on the current device
    dev = next_hop.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    current = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(dev):
        rc = lib.load_prop_launch(
            next_hop.data_ptr(), load0.data_ptr(), w.data_ptr(),
            flow.data_ptr(), B, n, max_hops, tile, rows, stream)
    if rc != 0:
        msg = lib.load_prop_error_string(rc).decode()
        raise RuntimeError(f"load-propagation kernel launch failed "
                           f"(cuda error {rc}: {msg}) at B={B}, n={n}")
    load_prop_cuda.launches += 1
    return w, flow


load_prop_cuda.launches = 0


__all__ = ["cuda_tile", "cuda_flow_rows", "cuda_plan", "pick_tile", "load_prop_plain",
           "load_prop_plain_blocked", "load_prop_cuda"]
