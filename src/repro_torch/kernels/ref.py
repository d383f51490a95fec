# Port of src/repro/kernels/ref.py.
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


def flow_accumulate_ref(flow: torch.Tensor, cur: torch.Tensor,
                        nxt: torch.Tensor, amount: torch.Tensor
                        ) -> torch.Tensor:
    """Scatter-add of per-pair traffic onto directed edges:

        out[u, v] = flow[u, v] + sum_p amount[p] * [cur[p]==u] * [nxt[p]==v]

    Supports an optional leading batch dimension on all operands. On the
    CPU ``index_add_`` adds the pairs to each cell in ascending p.
    """
    squeeze = flow.dim() == 2
    if squeeze:
        flow, cur, nxt, amount = flow[None], cur[None], nxt[None], amount[None]
    B, n, _ = flow.shape
    base = torch.arange(B, device=flow.device)[:, None] * (n * n)
    flat = (base + cur.long() * n + nxt.long()).reshape(-1)
    out = flow.reshape(-1).clone().index_add_(
        0, flat, amount.reshape(-1).to(flow.dtype)).reshape(B, n, n)
    return out[0] if squeeze else out


__all__ = ["BIG", "minplus_ref", "flow_accumulate_ref"]
