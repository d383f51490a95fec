"""Mamba-1 selective scan, forward and backward: the CUDA kernels and their
plain versions.

Port of ``src/repro/kernels/selective_scan.py``. Per sequence and channel,
with the N-vector state h:

    h_t = exp(dt_t · a) · h_{t-1} + (dt_t · x_t) · B_t,    y_t = Σ_n h_t · C_t

The forward pass also returns the state at the start of every ``chunk``
steps (``ckpt`` [B, S/chunk, Di, N], the reference's layout) and the final
state; the backward pass re-runs the recurrence from those checkpoints and
walks each chunk in reverse with the adjoint state.

* ``selective_scan_fwd_cuda`` — the Hopper kernel ``ssm_fwd`` in
  ``csrc/selective_scan.cu``; it replaces the TPU kernel
  ``src/repro/kernels/selective_scan.py:38`` (``_fwd_kernel``, B7). Each
  (sequence, channel) keeps its states in registers for the whole sequence,
  split over ``fwd_plan(N)["lanes"]`` lanes (4 at N = 16, four states a
  lane); a block of 32 channels stages x, dt, B_t and C_t for 32 steps in
  shared memory with ``cp.async``, one tile ahead of the steps, and y_t is
  each lane's partial sum closed by a fixed butterfly over the channel's
  lanes. Each state is updated by the step the backward's recomputation
  uses, so the checkpoints and hT do not depend on the layout (only y's
  summation order does); ``fwd_plan`` mirrors the block's layout and
  shared memory. ``launches`` counts its calls.
* ``selective_scan_bwd_cuda`` — the kernel ``ssm_bwd`` and a fixed-order
  partial sum; it replaces ``:116`` (``_bwd_kernel``, B8). One block per
  (sequence, 32 channels), each channel's states split over N/2 lanes (two
  a lane), walks all chunks in reverse; each chunk is recomputed in
  sub-chunks of ``bwd_sub_chunk(chunk)`` (16) steps, whose pre-step states
  sit in shared memory and whose a_bar the reverse walk reuses (two exps
  per state and step). The sub-chunk start states go to a global scratch
  the wrapper allocates; the block's shared memory (``bwd_smem_bytes``) does
  not depend on the chunk. ``launches`` counts its calls.
  At the training shape the forward is bound by its exps (just above its
  bytes) and the backward by its bytes; the source note in the ``.cu`` file
  gives the numbers and what the design does about them.
* ``selective_scan_fwd_plain`` — the sequential recurrence, one step at a
  time over the whole batch; ``selective_scan_bwd_plain`` — a transcription
  of the reference kernel's reverse walk. Both run on any device, and
  autograd through the plain forward gives the same gradients.

``kernels.ops.selective_scan_fwd`` and ``selective_scan_bwd`` pick by the
tensors' device: a CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version. ``ops.selective_scan`` applies the
``torch.autograd.Function`` that joins them, as the reference's
``custom_vjp`` does.

The reference took a channel block ``bd`` for its grid; the CUDA kernels fix
their own channel tiling, so the port's functions take no ``bd``.
"""
from __future__ import annotations

import ctypes

import torch

from .minplus import check_f32_cuda

MAX_STATE = 16                # N the kernels hold in registers
SMEM_MAX = 232448             # the H100's per-block opt-in limit (227 KB)


def _check_shapes(xc, dt, bm, cm, a, chunk: int) -> tuple[int, int, int, int,
                                                          int]:
    B, S, Di = xc.shape
    N = a.shape[1]
    if dt.shape != xc.shape or bm.shape != (B, S, N) or cm.shape != (B, S, N) \
            or a.shape != (Di, N):
        raise ValueError(f"selective scan takes xc, dt [B, S, Di], bm, cm "
                         f"[B, S, N] and a [Di, N], got "
                         f"{[tuple(t.shape) for t in (xc, dt, bm, cm, a)]}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of chunk "
                         f"{chunk}")
    return B, S, Di, N, chunk


def selective_scan_fwd_plain(xc, dt, bm, cm, a, h0, *, chunk: int = 256):
    """Plain forward on any device. Returns (y [B, S, Di], ckpt
    [B, S/chunk, Di, N], hT [B, Di, N])."""
    B, S, Di, N, chunk = _check_shapes(xc, dt, bm, cm, a, chunk)
    h = h0
    ys, ckpts = [], []
    for t in range(S):
        if t % chunk == 0:
            ckpts.append(h)
        dt_t = dt[:, t, :, None]
        a_bar = torch.exp(dt_t * a)
        bx = dt_t * xc[:, t, :, None] * bm[:, t, None, :]
        h = a_bar * h + bx
        ys.append((h * cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), torch.stack(ckpts, 1), h


def selective_scan_bwd_plain(xc, dt, bm, cm, a, h_ckpt, dy, *,
                             chunk: int = 256):
    """Plain backward on any device: the reference kernel's reverse walk
    over the whole batch. Returns (dxc, ddt, dbm, dcm, da, dh0)."""
    B, S, Di, N, chunk = _check_shapes(xc, dt, bm, cm, a, chunk)
    dxc = torch.empty_like(xc)
    ddt = torch.empty_like(dt)
    dbm = torch.empty_like(bm)
    dcm = torch.empty_like(cm)
    da = torch.zeros((B, Di, N), dtype=xc.dtype, device=xc.device)
    m = torch.zeros_like(da)
    for c in reversed(range(S // chunk)):
        t0 = c * chunk
        h = h_ckpt[:, c]
        pre = []                                   # h_{t-1} for t in the chunk
        for t in range(t0, t0 + chunk):
            pre.append(h)
            dt_t = dt[:, t, :, None]
            h = torch.exp(dt_t * a) * h + dt_t * xc[:, t, :, None] \
                * bm[:, t, None, :]
        for i in reversed(range(chunk)):
            t = t0 + i
            h_pre = pre[i]
            dt_t = dt[:, t, :, None]
            x_t = xc[:, t, :, None]
            b_t = bm[:, t, None, :]
            dy_t = dy[:, t, :, None]
            a_bar = torch.exp(dt_t * a)
            h_post = a_bar * h_pre + dt_t * x_t * b_t
            lam = dy_t * cm[:, t, None, :] + m
            d_a_bar = lam * h_pre
            lam_b = (lam * b_t).sum(-1)
            ddt[:, t] = (d_a_bar * a * a_bar).sum(-1) + lam_b * xc[:, t]
            dxc[:, t] = lam_b * dt[:, t]
            dbm[:, t] = (lam * dt_t * x_t).sum(1)
            dcm[:, t] = (dy_t * h_post).sum(1)
            da = da + d_a_bar * dt_t * a_bar
            m = a_bar * lam
    return dxc, ddt, dbm, dcm, da.sum(0), m


_F = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ssm_fwd_launch": (_I, [_F] * 9 + [_I] * 5 + [_F]),
    "ssm_bwd_launch": (_I, [_F] * 17 + [_I] * 5 + [_F]),
    "ssm_error_string": (ctypes.c_char_p, [_I]),
}


def _lib() -> ctypes.CDLL:
    from .build import library

    return library("selective_scan", _SIGNATURES)


def _raise(rc: int, what: str, shape) -> None:
    msg = _lib().ssm_error_string(rc).decode()
    raise RuntimeError(f"{what} launch failed (cuda error {rc}: {msg}) at "
                       f"B, S, Di, N = {shape}")


BWD_SUB = 16                  # steps per backward sub-chunk (kSub)
FWD_LANES = 4                 # lanes a channel in the forward (kFwdLanes)
FWD_CHANNELS = 32             # channels per forward block (kFwdChannels)
FWD_TILE = 32                 # steps per staged forward tile (kFwdTile)


def _padded_state(N: int) -> int:
    return 4 if N <= 4 else (8 if N <= 8 else 16)


def fwd_plan(N: int) -> dict:
    """The forward block's layout at N states (mirrors ``FwdShape`` in the
    .cu file): N padded to NP (4, 8 or 16), ``lanes`` a channel, state
    n = lane * states_per_lane + slot (states n >= N are padding), 32
    channels a block, and the static shared memory: two stages of x and dt
    [32 steps, 32 channels] and B_t and C_t [32 steps, NP], and y
    [32 steps, 32 channels]."""
    np_ = _padded_state(N)
    lanes = min(np_, FWD_LANES)
    stage = FWD_TILE * (2 * FWD_CHANNELS + 2 * np_)
    return {"padded": np_, "lanes": lanes, "states_per_lane": np_ // lanes,
            "channels": FWD_CHANNELS, "threads": FWD_CHANNELS * lanes,
            "smem_bytes": (2 * stage + FWD_TILE * FWD_CHANNELS) * 4}


def bwd_sub_chunk(chunk: int) -> int:
    """Steps per sub-chunk of the backward kernel: 16, or the chunk if it is
    shorter."""
    return min(chunk, BWD_SUB)


def bwd_smem_bytes(N: int) -> int:
    """Shared memory of one backward block at N states, whatever the chunk
    (mirrors the .cu file): per sub-chunk step the pre-step states (2 per
    thread, 16 NP threads), dt/x/dy in and ddt/dxc out for 32 channels, B_t
    and C_t, and each warp's dB/dC sums (2 NP)."""
    np_ = _padded_state(N)
    threads = 16 * np_
    return BWD_SUB * (2 * threads + 5 * 32 + 2 * np_
                      + threads // 32 * 2 * np_) * 4


def _check_state(N: int) -> None:
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"the selective-scan kernels hold N <= {MAX_STATE} "
                         f"states in registers, got N={N}")


def selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0, *, chunk: int = 256):
    """Launch the forward kernel on the current stream (contiguous float32
    on one sm_90 device). Returns (y, ckpt, hT); raises if the launch
    fails."""
    check_f32_cuda("selective_scan_fwd_cuda", xc, dt, bm, cm, a, h0)
    B, S, Di, N, chunk = _check_shapes(xc, dt, bm, cm, a, chunk)
    if h0.shape != (B, Di, N):
        raise ValueError(f"h0 must be [B, Di, N], got {tuple(h0.shape)}")
    _check_state(N)
    y = torch.empty_like(xc)
    ckpt = torch.empty((B, S // chunk, Di, N), dtype=torch.float32,
                       device=xc.device)
    ht = torch.empty_like(h0)
    if B * S * Di == 0:
        return y, ckpt, h0.clone()
    stream = torch.cuda.current_stream(xc.device)
    with torch.cuda.device(xc.device):
        rc = _lib().ssm_fwd_launch(
            xc.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), h0.data_ptr(), y.data_ptr(), ckpt.data_ptr(),
            ht.data_ptr(), B, S, Di, N, chunk, stream.cuda_stream)
    if rc != 0:
        _raise(rc, "selective-scan forward kernel", (B, S, Di, N))
    selective_scan_fwd_cuda.launches += 1
    return y, ckpt, ht


selective_scan_fwd_cuda.launches = 0


def selective_scan_bwd_cuda(xc, dt, bm, cm, a, h_ckpt, dy, *,
                            chunk: int = 256):
    """Launch the backward kernel and its fixed-order partial sums on the
    current stream. Returns (dxc, ddt, dbm, dcm, da, dh0); raises if a
    launch fails."""
    check_f32_cuda("selective_scan_bwd_cuda", xc, dt, bm, cm, a, h_ckpt, dy)
    B, S, Di, N, chunk = _check_shapes(xc, dt, bm, cm, a, chunk)
    if h_ckpt.shape != (B, S // chunk, Di, N) or dy.shape != xc.shape:
        raise ValueError(f"h_ckpt must be [B, S/chunk, Di, N] and dy "
                         f"[B, S, Di], got {tuple(h_ckpt.shape)} and "
                         f"{tuple(dy.shape)}")
    _check_state(N)
    dev = xc.device
    dxc, ddt = torch.empty_like(xc), torch.empty_like(xc)
    dbm, dcm = torch.empty_like(bm), torch.empty_like(cm)
    da = torch.empty((Di, N), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, Di, N), dtype=torch.float32, device=dev)
    if B * S * Di == 0:
        return dxc, ddt, dbm.zero_(), dcm.zero_(), da.zero_(), dh0.zero_()
    n_blk = -(-Di // 32)
    part_bm = torch.empty((B, n_blk, S, N), dtype=torch.float32, device=dev)
    part_cm = torch.empty_like(part_bm)
    part_da = torch.empty((B, Di, N), dtype=torch.float32, device=dev)
    starts = torch.empty((B, n_blk, -(-chunk // BWD_SUB),
                          32 * _padded_state(N)), dtype=torch.float32,
                         device=dev)
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        rc = _lib().ssm_bwd_launch(
            xc.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), h_ckpt.data_ptr(), dy.data_ptr(), dxc.data_ptr(),
            ddt.data_ptr(), dbm.data_ptr(), dcm.data_ptr(), da.data_ptr(),
            dh0.data_ptr(), part_bm.data_ptr(), part_cm.data_ptr(),
            part_da.data_ptr(), starts.data_ptr(), B, S, Di, N, chunk,
            stream.cuda_stream)
    if rc != 0:
        _raise(rc, "selective-scan backward kernel", (B, S, Di, N))
    selective_scan_bwd_cuda.launches += 1
    return dxc, ddt, dbm, dcm, da, dh0


selective_scan_bwd_cuda.launches = 0


__all__ = ["selective_scan_fwd_plain", "selective_scan_bwd_plain",
           "selective_scan_fwd_cuda", "selective_scan_bwd_cuda",
           "bwd_sub_chunk", "bwd_smem_bytes", "fwd_plan", "MAX_STATE"]
