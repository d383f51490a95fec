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

The reference runs the kernel per shard through ``shard_map`` under a mesh;
the port runs on one device. Decode is the O(1) recurrence step on a
carried (conv window, f32 state) cache: ``init_mamba_cache`` and
``mamba_decode_step``, plain PyTorch as in the reference (no kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import selective_scan
from .config import ModelConfig
from .layers import Params, _dense_init


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


def _ssm_params_from_x(p: Params, cfg: ModelConfig, xc: torch.Tensor):
    """xc: [..., Di] post-conv activations -> (dt, B, C) selective params."""
    dt_bc = torch.matmul(xc, p["x_proj"].to(xc.dtype))
    r, n = cfg.ssm_dt_rank, cfg.ssm_state
    dt, b_mat, c_mat = torch.split(dt_bc, [r, n, n], dim=-1)
    dt = torch.matmul(dt, p["dt_proj"].to(xc.dtype))
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
    """Kernel route: the fused scan (B7/B8 on CUDA), one device."""
    bb, ss, dd = xc32.shape
    h0 = torch.zeros((bb, dd, cfg.ssm_state), dtype=torch.float32,
                     device=xc32.device)
    chunk = _largest_divisor(ss, cfg.ssm_chunk)
    return selective_scan(xc32, dt, b_mat, c_mat, a, h0, chunk)


def mamba_forward(p: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    """Training/prefill path. x: [B, S, D] -> [B, S, D].

    S must be divisible by cfg.ssm_chunk (callers pad)."""
    b, s, d = x.shape
    di, n, kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    dt_ = x.dtype
    xz = torch.matmul(x, p["in_proj"].to(dt_))
    xin, z = torch.split(xz, di, dim=-1)

    # depthwise causal conv over sequence
    xpad = F.pad(xin, (0, 0, kc - 1, 0))
    conv_w = p["conv_w"].to(dt_)
    xc = xpad[:, 0:s, :] * conv_w[0]
    for i in range(1, kc):
        xc = xc + xpad[:, i:i + s, :] * conv_w[i]
    xc = F.silu(xc + p["conv_b"].to(dt_))

    dt, b_mat, c_mat = _ssm_params_from_x(p, cfg, xc)
    a = -torch.exp(p["a_log"])                                   # [Di, N]

    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by ssm_chunk {chunk}")
    n_chunks = s // chunk

    xc32 = xc.to(torch.float32)

    if cfg.ssm_kernel:
        y = _fused_selective_scan(cfg, xc32, dt, b_mat, c_mat, a)
    else:
        def chunk_step(h0, dt_c, b_c, c_c, x_c):
            a_bar = torch.exp(dt_c[..., None] * a)               # [B,T,Di,N]
            bx = dt_c[..., None] * b_c[:, :, None, :] * x_c[..., None]
            # fold the carried state into the first step
            bx = torch.cat([bx[:, :1] + a_bar[:, :1] * h0[:, None], bx[:, 1:]],
                           dim=1)
            h = _scan_chunk(a_bar, bx)                           # [B,T,Di,N]
            y_c = torch.einsum("btin,btn->bti", h, c_c)
            return h[:, -1], y_c

        h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
        ys = []
        for idx in range(n_chunks):
            sl = slice(idx * chunk, (idx + 1) * chunk)
            args = (h, dt[:, sl], b_mat[:, sl], c_mat[:, sl], xc32[:, sl])
            if cfg.remat != "none":
                h, y_c = checkpoint(chunk_step, *args, use_reentrant=False)
            else:
                h, y_c = chunk_step(*args)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)                                  # [B,S,Di]
    y = y + xc32 * p["d_skip"]
    y = y.to(dt_) * F.silu(z)
    return torch.matmul(y, p["out_proj"].to(dt_))


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Params:
    di, n, kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((batch, kc - 1, di), dtype=dtype, device=device),
        "state": torch.zeros((batch, di, n), dtype=torch.float32,
                             device=device),
    }


def mamba_decode_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                      cache: Params) -> tuple[torch.Tensor, Params]:
    """One-token decode. x: [B, 1, D]; cache: the last kc-1 conv inputs
    [B, kc-1, Di] and the ssm state [B, Di, N] (f32). Returns (y [B, 1, D],
    the new cache)."""
    di = cfg.d_inner
    dt_ = x.dtype
    xz = torch.matmul(x, p["in_proj"].to(dt_))
    xin, z = torch.split(xz, di, dim=-1)                        # [B,1,Di]

    conv_win = torch.cat([cache["conv"], xin], dim=1)           # [B,kc,Di]
    xc = (conv_win * p["conv_w"].to(dt_)).sum(dim=1)
    xc = F.silu(xc + p["conv_b"].to(dt_))[:, None, :]           # [B,1,Di]

    dt, b_mat, c_mat = _ssm_params_from_x(p, cfg, xc)
    a = -torch.exp(p["a_log"])
    xc32 = xc.to(torch.float32)[:, 0]
    a_bar = torch.exp(dt[:, 0, :, None] * a)                    # [B,Di,N]
    bx = dt[:, 0, :, None] * b_mat[:, 0, None, :] * xc32[..., None]
    h = a_bar * cache["state"] + bx                             # [B,Di,N]
    y = torch.einsum("bin,bn->bi", h, c_mat[:, 0])
    y = y + xc32 * p["d_skip"]
    y = y[:, None, :].to(dt_) * F.silu(z)
    out = torch.matmul(y, p["out_proj"].to(dt_))
    return out, {"conv": conv_win[:, 1:], "state": h}


__all__ = ["init_mamba", "mamba_forward", "softplus", "_ssm_params_from_x",
           "_fused_selective_scan", "_scan_chunk", "_largest_divisor",
           "init_mamba_cache", "mamba_decode_step"]
