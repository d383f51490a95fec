# Port of src/repro/kernels/ref.py (BIG and minplus_ref; flow_accumulate_ref
# waits for the flow-accumulation kernel).
"""Plain PyTorch oracles shared by the kernels."""
from __future__ import annotations

import torch

BIG = 1e18


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(min, +) matrix product: out[i, j] = min_k a[i, k] + b[k, j].

    Supports an optional leading batch dimension on both operands.
    """
    if a.dim() == 2:
        return (a[:, :, None] + b[None, :, :]).amin(dim=1)
    return (a[:, :, :, None] + b[:, None, :, :]).amin(dim=2)


__all__ = ["BIG", "minplus_ref"]
