"""Gradient-compression collectives; port of
``src/repro/sharding/compression.py``.

``compressed_psum`` quantizes a tensor to int8 with a per-block scale before
the cross-replica sum and dequantizes after: 4x less interconnect traffic
for the data-parallel gradient all-reduce at the cost of quantization
noise, which ``ErrorFeedback`` (residual carry, Seide et al. / EF-SGD)
corrects over steps.

The collectives are ``torch.distributed.all_reduce`` calls on a process
group (the reference's ``psum`` inside ``shard_map``): the int32 payload,
the scales and a ones scalar, as the reference's three ``psum``s.
``make_compressed_allreduce`` takes a ``DeviceMesh`` and reduces over each
named dimension's group in turn.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Blockwise symmetric int8 quantization: returns (q [nb, block] int8,
    scales [nb, 1] f32), the same bits on every device. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block).to(torch.float32)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which is not the correctly rounded quotient
    scale = blocks.abs().amax(dim=1, keepdim=True) / blocks.new_tensor(127.0)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = math.prod(shape)
    return flat[:n].reshape(shape).to(dtype)


def compressed_psum(x: torch.Tensor, group=None, block: int = 256):
    """int8 quantize -> all-reduce (int32 accumulation) -> dequantize, over
    ``group`` (None: the default group).

    Accumulating int8 payloads in int32 keeps the wire format 1 byte a
    value in principle while avoiding overflow up to ~16M replicas."""
    q, scale = quantize_int8(x, block)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    ssum = scale.clone()
    dist.all_reduce(ssum, group=group)    # scales are cheap (1/block values)
    n_rep = torch.ones((), dtype=torch.float32, device=x.device)
    dist.all_reduce(n_rep, group=group)
    return dequantize_int8(qsum, ssum / n_rep, x.shape, x.dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_compressed_allreduce(mesh, axes=("pod", "data"), block: int = 256):
    """Tree-wide compressed gradient all-reduce (the mean over replicas)
    over the ``DeviceMesh`` dimensions named in ``axes``."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in axes if a in names)
    n = math.prod(mesh.size(names.index(a)) for a in axes)

    def inner(g):
        out = g
        for a in axes:
            out = compressed_psum(out, mesh.get_group(a), block)
        return out / n

    def allreduce(grads):
        return _map(inner, grads)

    return allreduce


class ErrorFeedback:
    """EF-SGD residual carry: compress(g + e), keep e = (g + e) -
    decompress. The state is a dict like the grads; ``apply`` returns
    (compressed approximation, new state)."""

    @staticmethod
    def init(grads):
        return _map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    @staticmethod
    def apply(grads, state, block: int = 256):
        if isinstance(grads, dict):
            pairs = {k: ErrorFeedback.apply(g, state[k], block)
                     for k, g in grads.items()}
            return ({k: c for k, (c, _) in pairs.items()},
                    {k: e for k, (_, e) in pairs.items()})
        x = grads.to(torch.float32) + state
        q, s = quantize_int8(x, block)
        approx = dequantize_int8(q, s, x.shape, torch.float32)
        return approx.to(grads.dtype), x - approx


__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "make_compressed_allreduce", "ErrorFeedback"]
