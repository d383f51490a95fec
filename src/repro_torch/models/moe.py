"""Mixture-of-Experts FFN with capacity-based one-hot dispatch
(GShard/Switch-style) in PyTorch; port of ``src/repro/models/moe.py``.

DeepSeek-style shared experts (always on) beside fine-grained routed
experts with top-k gating, and OLMoE-style plain top-k. Tokens beyond an
expert's capacity are dropped (their combine weight is zero); the Switch
aux load-balancing loss keeps drops rare.

Two of the reference's primitives have no exact twin in PyTorch:

* ``jax.lax.top_k`` puts the lower expert index first on ties;
  ``torch.topk`` promises no order, so ``_top_k`` takes a stable sort of
  the negated probabilities.
* ``jax.nn.one_hot`` of an index outside [0, n) is a zero row (an unrouted
  slot's position -1, an overflow's position >= capacity);
  ``torch.nn.functional.one_hot`` raises, so ``_one_hot`` compares against
  ``arange``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import Params, _dense_init, activate, init_mlp, mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": _dense_init(gen, (d, e), device=device),
         "wi": _dense_init(gen, (e, d, f), d, device=device)}
    if cfg.mlp == "swiglu":
        p["wg"] = _dense_init(gen, (e, d, f), d, device=device)
    p["wo"] = _dense_init(gen, (e, f, d), f, device=device)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg,
                               d_ff=cfg.moe_d_ff * cfg.n_shared_experts,
                               device=device)
    return p


def _capacity(cfg: ModelConfig, group_size: int) -> int:
    c = int(group_size * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, cfg.top_k)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n, dtype=float32)``: a row of zeros where idx
    lies outside [0, n)."""
    ids = torch.arange(n, device=idx.device)
    return (idx[..., None] == ids).to(torch.float32)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lower index first among equal values."""
    order = torch.sort(-probs, dim=-1, stable=True).indices[..., :k]
    return torch.gather(probs, -1, order), order


def moe_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss).

    Tokens are reshaped into groups of ``min(moe_group_size, B*S)``; within
    each group the top-k experts per token are selected and tokens are
    placed into expert capacity slots via one-hot position products."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    g_size = min(cfg.moe_group_size, b * s)
    n_groups = (b * s) // g_size
    if n_groups * g_size != b * s:
        raise ValueError(f"tokens {b * s} not divisible by moe_group_size "
                         f"{g_size}")
    xt = x.reshape(n_groups, g_size, d)

    # --- routing ---
    logits = torch.matmul(xt, p["router"].to(dt))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)                   # [G,T,k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)                 # renormalise

    # --- aux load-balancing loss (Switch): e * sum(frac_tokens * frac_prob)
    me = probs.mean(dim=1)                                     # [G,E]
    ce = _one_hot(expert_idx[..., 0], e).mean(dim=1)           # [G,E]
    aux = e * (me * ce).sum(dim=-1).mean()

    # --- capacity assignment ---
    cap = _capacity(cfg, g_size)
    disp_onehot = _one_hot(expert_idx, e)                      # [G,T,k,E]
    # position of each (token, choice) within its expert's queue
    pos = torch.cumsum(disp_onehot.reshape(n_groups, g_size * k, e), dim=1)
    pos = pos.reshape(n_groups, g_size, k, e) * disp_onehot - 1.0
    in_cap = ((pos >= 0) & (pos < cap)).to(torch.float32)
    gate_vals = gate_vals * in_cap.amax(dim=-1)                # drop overflow
    pos_onehot = _one_hot(pos.to(torch.int32), cap)            # [G,T,k,E,C]
    routed = disp_onehot * in_cap
    dispatch = torch.einsum("gtke,gtkec->gtec", routed, pos_onehot)
    combine = torch.einsum("gtke,gtkec->gtec",
                           gate_vals[..., None] * routed, pos_onehot)
    dispatch = dispatch.to(dt)
    combine = combine.to(dt)

    # --- expert computation ---
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xt)          # [G,E,C,D]
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"].to(dt))
    hg = (torch.einsum("gecd,edf->gecf", xe, p["wg"].to(dt))
          if cfg.mlp == "swiglu" else None)
    h = activate(cfg, h, hg)
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))     # [G,E,C,D]
    y = torch.einsum("gtec,gecd->gtd", combine, ye)            # [G,T,D]

    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], cfg, xt)
    return y.reshape(b, s, d), aux.to(torch.float32)


__all__ = ["init_moe", "moe_ffn", "_capacity", "_one_hot", "_top_k"]
