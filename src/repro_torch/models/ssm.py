"""Mamba-1 selective state-space block (arXiv:2312.00752) in PyTorch; port
of the training path of ``src/repro/models/ssm.py``.

Two routes through the scan, as in the reference:

* ``cfg.ssm_kernel=True``: ``_fused_selective_scan`` calls
  ``kernels.ops.selective_scan``, the autograd function around the
  hand-written forward (B7) and backward (B8) kernels on CUDA, their plain
  versions on the CPU;
* otherwise the **chunked associative scan**: a loop over sequence chunks
  with a first-order linear-recurrence associative scan inside each chunk
  (the reference's ``lax.associative_scan``, transcribed), each chunk under
  ``torch.utils.checkpoint`` when remat is on. This is the default config's
  path and the model-level plain version of the kernel route.

Under a mesh (``sharding.spmd``) the mixer runs tensor-parallel over
"model" where its channels divide the axis (``SSM_SPLIT``): each rank
holds its run of ``Di / tp`` channels of every leaf, takes its channels of
x and z from ``in_proj`` (``mamba_forward``), convolves them, sums its
part of ``x_proj``'s product ``[dt | B | C]`` over "model", expands dt to
its channels with ``dt_proj``, scans them and sums its part of
``out_proj``'s product. The scan thus runs once a shard, as the
reference's ``shard_map`` runs its kernel: each rank scans its own batch
rows and channels, with no collective inside. Decode is the O(1)
recurrence step on a carried (conv window, f32 state) cache:
``init_mamba_cache`` and ``mamba_decode_step``, plain PyTorch as in the
reference (no kernel), on this rank's channels under a mesh.

``in_proj`` keeps the reference's layout, one ``[D, 2 Di]`` leaf split on
its columns, so a rank's columns are not its channels of both x and z (on
a model axis of 2, rank 0 holds all of x and rank 1 all of z). Training
and prefill exchange the weight's columns over "model" after the FSDP
gather (``sharding.spmd.halves_over_model``, an all-to-all of ``D x
2 Di / tp`` elements a layer, the reverse exchange on its gradient): that
costs the same at any batch and leaves one product of this rank's
columns. A decode step exchanges the product instead (``[B, 1, 2 Di /
tp]``, far smaller than the weight at one token a row).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import selective_scan
from ..sharding.spmd import (data_whole, gather_over_model,
                              halves_over_model, model_slice,
                              sum_grads_over_model, sum_over_model)
from .config import ModelConfig
from .layers import Params, _dense_init, contract_first

# the tensor dim of each leaf that the channels split over "model"
# (``sharding.spmd.split_over_model``): the rules' "ssm_inner"
SSM_SPLIT = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0,
             "dt_proj": 1, "dt_bias": 0, "a_log": 0, "d_skip": 0,
             "out_proj": 0}


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    """Drawn and computed on the host (``gen`` is a CPU generator), then
    moved to ``device``: the card's ``log`` may round ``a_log`` otherwise."""
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    f32 = dict(dtype=torch.float32)
    # S4D-real initialization for A
    a_init = torch.arange(1, n + 1, **f32)[None, :].repeat(di, 1)
    p = {
        "in_proj": _dense_init(gen, (d, 2 * di), d),
        "conv_w": _dense_init(gen, (cfg.ssm_conv, di), cfg.ssm_conv),
        "conv_b": torch.zeros((di,), **f32),
        "x_proj": _dense_init(gen, (di, r + 2 * n), di),
        "dt_proj": _dense_init(gen, (r, di), r),
        "dt_bias": torch.full((di,), -4.6, **f32),   # softplus^-1(0.01)
        "a_log": torch.log(a_init),
        "d_skip": torch.ones((di,), **f32),
        "out_proj": _dense_init(gen, (di, d), di),
    }
    return {k: v.to(device) for k, v in p.items()}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params_from_x(p: Params, cfg: ModelConfig, xc: torch.Tensor,
                       split: bool = False):
    """xc: [..., Di] post-conv activations -> (dt, B, C) selective params.
    ``split``: xc holds this rank's channels and ``p`` their leaves;
    ``x_proj``'s partial product is summed over "model" (and its gradient,
    which this rank's channels give in part, too)."""
    dt_bc = torch.matmul(xc, p["x_proj"].to(xc.dtype))
    if split:
        dt_bc = sum_grads_over_model(sum_over_model(dt_bc))
    r, n = cfg.ssm_dt_rank, cfg.ssm_state
    dt, b_mat, c_mat = torch.split(dt_bc, [r, n, n], dim=-1)
    # contiguous: a strided operand's product takes another path when the
    # weight needs no gradient (a meshed step's gathered weight)
    dt = torch.matmul(dt.contiguous(), p["dt_proj"].to(xc.dtype))
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    return dt, b_mat.to(torch.float32), c_mat.to(torch.float32)


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the first-order recurrence h_t = a_t h_{t-1} + b_t
    along axis 1: the odd/even recursion of ``jax.lax.associative_scan``
    with the combine (a_l, b_l), (a_r, b_r) -> (a_l a_r, a_r b_l + b_r).
    Returns (prod a, h)."""
    def combine(al, bl, ar, br):
        return al * ar, ar * bl + br

    num = a.shape[1]
    if num < 2:
        return a, b
    oa, ob = _associative_scan(*combine(a[:, 0:-1:2], b[:, 0:-1:2],
                                        a[:, 1::2], b[:, 1::2]))
    if num % 2 == 0:
        ea, eb = combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)

    def interleave(even, odd):
        shape = list(even.shape)
        shape[1] += odd.shape[1]
        out = even.new_empty(shape)
        out[:, 0::2] = even
        out[:, 1::2] = odd
        return out

    return interleave(ea, oa), interleave(eb, ob)


def _scan_chunk(a_bar: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """First-order recurrence h_t = a_t * h_{t-1} + bx_t over axis 1 via
    associative scan. a_bar, bx: [B, T, Di, N]."""
    return _associative_scan(a_bar, bx)[1]


def _largest_divisor(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _fused_selective_scan(cfg: ModelConfig, xc32, dt, b_mat, c_mat, a):
    """Kernel route: the fused scan (B7/B8 on CUDA)."""
    bb, ss, dd = xc32.shape
    h0 = torch.zeros((bb, dd, cfg.ssm_state), dtype=torch.float32,
                     device=xc32.device)
    chunk = _largest_divisor(ss, cfg.ssm_chunk)
    return selective_scan(xc32, dt, b_mat, c_mat, a, h0, chunk)


def _chunked_scan(cfg: ModelConfig, xc32, dt, b_mat, c_mat, a):
    """The chunked associative scan, each chunk under remat."""
    b, s, di = xc32.shape
    chunk = min(cfg.ssm_chunk, s)

    def chunk_step(h0, dt_c, b_c, c_c, x_c):
        a_bar = torch.exp(dt_c[..., None] * a)                   # [B,T,Di,N]
        bx = dt_c[..., None] * b_c[:, :, None, :] * x_c[..., None]
        # fold the carried state into the first step
        bx = torch.cat([bx[:, :1] + a_bar[:, :1] * h0[:, None], bx[:, 1:]],
                       dim=1)
        h = _scan_chunk(a_bar, bx)                               # [B,T,Di,N]
        y_c = torch.einsum("btin,btn->bti", h, c_c)
        return h[:, -1], y_c

    h = torch.zeros((b, di, cfg.ssm_state), dtype=torch.float32,
                    device=xc32.device)
    ys = []
    for idx in range(s // chunk):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        args = (h, dt[:, sl], b_mat[:, sl], c_mat[:, sl], xc32[:, sl])
        if cfg.remat != "none":
            h, y_c = checkpoint(chunk_step, *args, use_reentrant=False)
        else:
            h, y_c = chunk_step(*args)
        ys.append(y_c)
    return torch.cat(ys, dim=1)                                   # [B,S,Di]


def _selective_scan(cfg: ModelConfig, xc32, dt, b_mat, c_mat, a):
    """The scan by the config's route, on the channels it is given: under a
    mesh (``mamba_forward(..., split=True)``) this rank's rows and run of
    channels, xc and dt as [B/dp, S, Di/tp], B and C as [B/dp, S, N], A as
    [Di/tp, N], as the reference's ``shard_map`` runs its kernel once a
    shard, with no collective inside."""
    route = _fused_selective_scan if cfg.ssm_kernel else _chunked_scan
    return route(cfg, xc32, dt, b_mat, c_mat, a)


def mamba_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  split: bool = False) -> torch.Tensor:
    """Training/prefill path. x: [B, S, D] -> [B, S, D].

    S must be divisible by cfg.ssm_chunk (callers pad). ``split``: ``p``
    holds this rank's channels of every leaf (``SSM_SPLIT``) and x is
    whole over "model"; each rank's output is its part of the sum, added
    up over the axis."""
    s = x.shape[1]
    kc = cfg.ssm_conv
    dt_ = x.dtype
    w_in = p["in_proj"]
    if split:
        x, w_in = sum_grads_over_model(x), halves_over_model(w_in, 1)
    xz = torch.matmul(x, w_in.to(dt_))
    xin, z = torch.split(xz, xz.shape[-1] // 2, dim=-1)

    # depthwise causal conv over sequence
    xpad = F.pad(xin, (0, 0, kc - 1, 0))
    conv_w = p["conv_w"].to(dt_)
    xc = xpad[:, 0:s, :] * conv_w[0]
    for i in range(1, kc):
        xc = xc + xpad[:, i:i + s, :] * conv_w[i]
    xc = F.silu(xc + p["conv_b"].to(dt_))

    dt, b_mat, c_mat = _ssm_params_from_x(p, cfg, xc, split)
    a = -torch.exp(p["a_log"])                                   # [Di, N]

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by ssm_chunk {chunk}")

    xc32 = xc.to(torch.float32)
    y = _selective_scan(cfg, xc32, dt, b_mat, c_mat, a)
    y = y + xc32 * p["d_skip"]
    y = y.to(dt_) * F.silu(z)
    out = torch.matmul(y, p["out_proj"].to(dt_))
    return sum_over_model(out) if split else out


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Params:
    di, n, kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((batch, kc - 1, di), dtype=dtype, device=device),
        "state": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=device),
    }


def mamba_decode_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      cache: Params, dims: dict | None = None
                      ) -> tuple[torch.Tensor, Params]:
    """One-token decode. x: [B, 1, D]; cache: the last kc-1 conv inputs
    [B, kc-1, Di] and the ssm state [B, Di, N] (f32). Returns (y [B, 1, D],
    the new cache).

    Under a mesh ``p`` holds each leaf's "model" part
    (``sharding.spmd.model_parts``) and ``dims`` the tensor dim each is
    split on there, and the cache may hold this rank's channels
    ("ssm_inner" over "model"): then the step runs on them. ``in_proj``
    holds x and z side by side, so its "model" part is not one rank's
    channels of both: its product ([B, 1, 2 Di / tp], small at decode) is
    exchanged over "model" into this rank's channels of x and z
    (``halves_over_model``), or gathered where the cache holds every
    channel. ``x_proj`` and ``out_proj`` are row-parallel (their partial
    products summed over "model"), ``dt_proj`` column-parallel; the conv,
    ``a_log`` and ``d_skip`` stay local. No leaf is gathered over
    "model". Where the rows are whole on the data axes, ``in_proj`` and
    ``out_proj`` hold this rank's data shard of ``d_model`` too: the first
    contracts x's columns there (summed over the data axes), the second
    gives this rank's output columns (gathered); the other leaves have no
    data shard."""
    di = cfg.d_inner
    dims = dims or {}
    split = cache["state"].shape[1] != di       # this rank's channels

    def chan(name: str, dim: int) -> torch.Tensor:
        """This rank's channels of a leaf along ``dim``."""
        if split and dims.get(name) is None:
            return model_slice(p[name], dim)
        return p[name]

    def rows(y: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's output, summed over the channels."""
        return sum_over_model(y) if split else y

    dt_ = x.dtype
    xz = contract_first(x, p["in_proj"])
    if dims.get("in_proj") is not None and split:
        xz = halves_over_model(xz, -1)              # this rank's x and z
    elif dims.get("in_proj") is not None:
        xz = gather_over_model(xz, -1)
    elif split:
        xz = torch.cat([model_slice(h, -1) for h in xz.chunk(2, dim=-1)],
                       dim=-1)
    xin, z = torch.split(xz, xz.shape[-1] // 2, dim=-1)         # [B,1,Di]

    conv_win = torch.cat([cache["conv"], xin], dim=1)           # [B,kc,Di]
    xc = (conv_win * chan("conv_w", 1).to(dt_)).sum(dim=1)
    xc = F.silu(xc + chan("conv_b", 0).to(dt_))[:, None, :]     # [B,1,Di]

    dt_bc = rows(torch.matmul(xc, chan("x_proj", 0).to(xc.dtype)))
    r, n = cfg.ssm_dt_rank, cfg.ssm_state
    dt, b_mat, c_mat = torch.split(dt_bc, [r, n, n], dim=-1)
    dt = torch.matmul(dt.contiguous(), chan("dt_proj", 1).to(xc.dtype))
    dt = softplus(dt.to(torch.float32) + chan("dt_bias", 0))
    b_mat, c_mat = b_mat.to(torch.float32), c_mat.to(torch.float32)
    a = -torch.exp(chan("a_log", 0))
    xc32 = xc.to(torch.float32)[:, 0]
    a_bar = torch.exp(dt[:, 0, :, None] * a)                    # [B,Di,N]
    bx = dt[:, 0, :, None] * b_mat[:, 0, None, :] * xc32[..., None]
    h = a_bar * cache["state"] + bx                             # [B,Di,N]
    y = torch.einsum("bin,bn->bi", h, c_mat[:, 0])
    y = y + xc32 * chan("d_skip", 0)
    y = y[:, None, :].to(dt_) * F.silu(z)
    out = rows(torch.matmul(y, chan("out_proj", 0).to(dt_)))
    return data_whole(out, x.shape[-1]), {"conv": conv_win[:, 1:],
                                          "state": h}


__all__ = ["SSM_SPLIT", "init_mamba", "mamba_forward", "softplus",
           "_ssm_params_from_x", "_fused_selective_scan", "_chunked_scan",
           "_selective_scan", "_scan_chunk", "_largest_divisor",
           "init_mamba_cache", "mamba_decode_step"]
