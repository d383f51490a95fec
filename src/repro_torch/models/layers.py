"""Shared layers for the SSM family in PyTorch; port of the parts of
``src/repro/models/layers.py`` that a Mamba-only model uses: the dense
initialiser, RMSNorm, the embedding and the unembedding. Attention, the MLPs
and RoPE wait for a later slice (ROADMAP Queue A 14).

Functions take a param dict and activations, as the reference's do; the
reference's logical-axis ``shard`` annotations are dropped (one device).
"""
from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]


def _dense_init(gen: torch.Generator, shape, in_axis_size=None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=gen, dtype=dtype) * scale).to(device)


def init_rmsnorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(dt)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   device=None) -> Params:
    return {"table": (torch.randn((vocab, d), generator=gen,
                                  dtype=torch.float32) * 0.02).to(device)}


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["table"].to(dtype)[tokens]


def init_unembed(gen: torch.Generator, d: int, vocab: int,
                 device=None) -> Params:
    return {"w": _dense_init(gen, (d, vocab), device=device)}


def unembed(p: Params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """Logits in float32 from operands rounded to x's dtype. The values are
    the reference's (a bf16 product with ``preferred_element_type=float32``:
    products of bf16 values are exact in f32), but the product here is an
    f32 GEMM standing in for that bf16 tensor-core product, so it costs an
    f32 GEMM's time."""
    w = p["w"].to(x.dtype)
    logits = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


__all__ = ["Params", "_dense_init", "init_rmsnorm", "rmsnorm",
           "init_embedding", "embed", "init_unembed", "unembed"]
