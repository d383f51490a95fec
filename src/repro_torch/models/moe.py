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

from ..sharding.spmd import (batch_shards, data_block, data_whole,
                              decode_part, decode_split, gather_rows,
                              model_slice, split_over_model,
                              sum_grads_over_model, sum_over_data,
                              sum_over_model, take_rows, whole_params)
from .config import ModelConfig
from .layers import (MLP_SPLIT, Params, _dense_init, activate,
                     contract_first, init_mlp, mlp)

# the tensor dim of each routed expert leaf that expert parallelism splits
# over "model" (``sharding.spmd.split_over_model``): the expert axis
EXPERT_SPLIT = {"wi": 0, "wg": 0, "wo": 0}


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


def moe_parts(p: Params, decode: bool = False) -> tuple[Params, dict]:
    """A MoE layer's parameters for this rank under a mesh
    (``sharding.spmd``; as they are without one): the router gathered
    whole (its spec keeps it whole over "model"), the routed experts this
    rank's ``E / tp`` of them where the experts divide "model"
    (``EXPERT_SPLIT``), the shared expert its hidden units of a
    tensor-parallel MLP (``MLP_SPLIT``). ``decode``: a decode step's, each
    leaf keeping its data shard where the rows are whole on the data axes
    (``decode_part``, ``decode_split``). Returns (params, {"experts":
    split, "shared": split}), ``moe_ffn``'s flags."""
    split = decode_split if decode else split_over_model
    experts, ep = split(
        {k: v for k, v in p.items() if k in EXPERT_SPLIT}, EXPERT_SPLIT)
    router = (decode_part(p["router"])[0] if decode
              else whole_params(p["router"]))
    out = {"router": router, **experts}
    shared = False
    if "shared" in p:
        out["shared"], shared = split(p["shared"], MLP_SPLIT)
    return out, {"experts": ep, "shared": shared}


def moe_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor,
            shared_split: bool = False, experts_split: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y, aux_loss).

    Tokens are reshaped into groups of ``min(moe_group_size, B*S)``; within
    each group the top-k experts per token are selected and tokens are
    placed into expert capacity slots via one-hot position products.

    Under a mesh (``sharding.spmd``) a rank holds its rows of the batch. Its
    tokens form the groups one device forms of them where they are a
    multiple of one device's group size; otherwise (a decode step's
    ``[B/dp, 1, D]``, fewer tokens than a group) the rows are gathered over
    the data axes, the whole batch is routed as on one device, so the same
    tokens are dropped, and each rank keeps its rows. Routing, the aux loss
    and the capacity assignment run whole on every model rank, so every
    model rank of a data group drops the same tokens. ``experts_split``
    (expert parallelism, the dense form of the reference's dispatch with
    the expert axis on "model"): ``p`` holds this rank's ``E / tp``
    experts, which take this rank's slice of the dispatch and the combine;
    the tokens and the gate values enter the region (their gradients
    summed over "model") and each rank's output, its experts' part of the
    sum, is summed over "model". ``shared_split``: the shared expert holds
    this rank's hidden units of a tensor-parallel MLP over "model"
    (``layers.mlp``). Where the leaves hold a decode step's data shard of
    ``d_model`` (``moe_parts(..., decode=True)`` with the rows whole on
    the data axes), the router's logits and the experts' hidden units are
    summed over the data axes from x's columns there, and the output
    columns of the experts and the shared expert are gathered once."""
    gathered = False
    shards = batch_shards()
    if shards > 1:
        tokens = x.shape[0] * x.shape[1]
        if tokens % min(cfg.moe_group_size, tokens * shards):
            x, gathered = gather_rows(x), True
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
    logits = contract_first(xt, p["router"])
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
    routed = disp_onehot * in_cap
    xin = xt
    if experts_split:
        # this rank's experts: its slice of the expert axis, whose
        # gradients of the gate values and the tokens are partial
        routed, pos = model_slice(routed, 3), model_slice(pos, 3)
        gate_vals = sum_grads_over_model(gate_vals)
        xin = sum_grads_over_model(xt)
    pos_onehot = _one_hot(pos.to(torch.int32), cap)            # [G,T,k,E,C]
    dispatch = torch.einsum("gtke,gtkec->gtec", routed, pos_onehot)
    combine = torch.einsum("gtke,gtkec->gtec",
                           gate_vals[..., None] * routed, pos_onehot)
    dispatch = dispatch.to(dt)
    combine = combine.to(dt)

    # --- expert computation ---
    # experts that hold a data shard of d_model take the tokens' columns
    # there (d stays the whole width)
    xin = data_block(xin, p["wi"].shape[1])
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xin)         # [G,E,C,D]
    h = torch.einsum("gecd,edf->gecf", xe, p["wi"].to(dt))
    hg = (torch.einsum("gecd,edf->gecf", xe, p["wg"].to(dt))
          if cfg.mlp == "swiglu" else None)
    if xin.shape[-1] != d:
        h, hg = sum_over_data(h, hg)
    h = activate(cfg, h, hg)
    ye = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))     # [G,E,C,D]
    y = torch.einsum("gtec,gecd->gtd", combine, ye)            # [G,T,D]
    if experts_split:
        y = sum_over_model(y)

    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], cfg, xt, split=shared_split, gather=False)
    y = data_whole(y, d).reshape(b, s, d)
    return (take_rows(y) if gathered else y), aux.to(torch.float32)


__all__ = ["EXPERT_SPLIT", "init_moe", "moe_parts", "moe_ffn", "_capacity",
           "_one_hot", "_top_k"]
