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
                              model_slice, rows_gathered, seq_block,
                              seq_counts_before, split_over_model,
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


def _in_capacity(pos: torch.Tensor, cap: int) -> torch.Tensor:
    """1 where a (token, choice, expert) position lies in the expert's
    ``cap`` slots, 0 where the pair did not choose the expert or overflows
    (dropped)."""
    return ((pos >= 0) & (pos < cap)).to(torch.float32)


def gathers_rows(cfg: ModelConfig, tokens: int) -> bool:
    """Whether ``moe_ffn`` gathers a rank's ``tokens`` tokens over the data
    axes under a mesh (``sharding.spmd``): where the batch's rows are split
    and the rank's tokens are no multiple of one device's group (a decode
    step's ``[B/dp, 1, D]``); never without a mesh."""
    shards = batch_shards()
    return shards > 1 and tokens % min(cfg.moe_group_size,
                                       tokens * shards) != 0


def moe_parts(p: Params, decode: bool = False, gathered: bool = False
              ) -> tuple[Params, dict]:
    """A MoE layer's parameters for this rank under a mesh
    (``sharding.spmd``; as they are without one): the router gathered
    whole (its spec keeps it whole over "model"), the routed experts this
    rank's ``E / tp`` of them where the experts divide "model"
    (``EXPERT_SPLIT``), the shared expert its hidden units of a
    tensor-parallel MLP (``MLP_SPLIT``). ``decode``: a decode step's, each
    leaf keeping its data shard where the rows are whole on the data axes
    (``decode_part``, ``decode_split``); ``gathered``: where ``moe_ffn``
    will gather the step's rows over the data axes (``gathers_rows``), so
    that they are whole there (``rows_gathered``). Returns (params,
    {"experts": split, "shared": split}), ``moe_ffn``'s flags."""
    split = decode_split if decode else split_over_model
    with rows_gathered(decode and gathered):
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
    ``[B/dp, 1, D]``, fewer tokens than a group: ``gathers_rows``) the
    rows are gathered over the data axes, the whole batch is routed as on
    one device, so the same tokens are dropped, and each rank keeps its
    rows; the layer runs in ``sharding.spmd.rows_gathered`` there.
    Routing, the aux loss and the capacity assignment run whole on every
    model rank, so every model rank of a data group drops the same
    tokens. ``experts_split`` (expert parallelism, the dense form of the
    reference's dispatch with the expert axis on "model"): ``p`` holds
    this rank's ``E / tp`` experts, which take this rank's slice of the
    dispatch and the combine; the tokens and the gate values enter the
    region (their gradients summed over "model") and each rank's output,
    its experts' part of the sum, is summed over "model".
    ``shared_split``: the shared expert holds
    this rank's hidden units of a tensor-parallel MLP over "model"
    (``layers.mlp``). Where the leaves hold a decode step's data shard of
    ``d_model`` (``moe_parts(..., decode=True)`` with the rows whole on
    the data axes, or gathered there), the router's logits and the
    experts' hidden units are summed over the data axes from x's columns
    there, the combine gives the rank's output columns, and those of the
    experts and the shared expert are gathered once.

    Where x is a data rank's block of the sequence (a prefill under
    ``sharding.spmd.sequence``), the groups are one device's,
    ``min(moe_group_size, B x S)`` consecutive tokens of the flattened
    batch: a block of whole groups routes them where it is, so it drops the
    tokens one device drops; any other block routes its own tokens too and
    exchanges only counts (``_routed_in_blocks``)."""
    blk = seq_block()
    gathered = gathers_rows(cfg, x.shape[0] * x.shape[1])
    if gathered:
        x = gather_rows(x)
    with rows_gathered(gathered):
        y, aux = _routed(p, cfg, x, blk, shared_split, experts_split)
    return (take_rows(y) if gathered else y), aux


def _routed(p: Params, cfg: ModelConfig, x: torch.Tensor, blk,
            shared_split: bool, experts_split: bool):
    """``moe_ffn`` on the tokens ``x`` as they are routed (the rank's own,
    the gathered batch, or a data rank's block of the sequence, ``blk``)."""
    g_size = min(cfg.moe_group_size, x.shape[0] * x.shape[1])
    if blk is not None:
        # one device's groups: a block of whole groups routes them where
        # it is, a block of part of one routes its own tokens
        g_size = min(cfg.moe_group_size, x.shape[0] * blk[2])
        if x.shape[1] % g_size:
            return _routed_in_blocks(p, cfg, x, blk, g_size, shared_split,
                                     experts_split)
        blk = None
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
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
    in_cap = _in_capacity(pos, cap)
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
    return data_whole(y, d).reshape(b, s, d), aux.to(torch.float32)


def _routed_in_blocks(p: Params, cfg: ModelConfig, x: torch.Tensor, blk,
                      g_size: int, shared_split: bool, experts_split: bool):
    """``_routed`` on this rank's block ``blk`` (start, n, total) of a
    sequence in blocks whose routing groups (``g_size`` consecutive tokens
    of the flattened [B, total] batch) are not whole in a block: the rank
    routes only its own tokens x [B, n, D], as one device routes them.

    The router, the softmax, top-k and the renormalised gates are a
    token's own. Two things couple a group's tokens: a (token, choice)'s
    capacity position, the count of the group's earlier pairs that chose
    its expert, and the aux loss's per-group means. So each block counts,
    for each group it touches, the pairs that chose each expert, the
    router's probabilities and the top-1 choices; one all-gather of those
    counts over the sequence's axes (``seq_counts_before``) gives each
    token's offset (the pairs of its group in the blocks before it, in the
    flattened order) and the groups' totals. The same tokens are dropped
    as on one device. The dense dispatch, the experts and the combine then
    run on the rank's tokens in their one-device capacity slots of the
    groups it touches (an expert's output for a slot depends only on the
    slot's token), so a rank computes those groups' experts, not every
    group's; no activation crosses the blocks."""
    start, n, total = blk
    b, _, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt, dev = x.dtype, x.device
    cap = _capacity(cfg, g_size)
    group, touched = block_groups(b, blk, g_size, dev)
    local = torch.full((b * total // g_size,), -1, dtype=torch.int64,
                       device=dev)
    local[touched] = torch.arange(len(touched), device=dev)
    xt = x.reshape(b * n, d)

    # --- routing, a token's own ---
    logits = contract_first(xt, p["router"])
    probs = torch.softmax(logits.to(torch.float32), dim=-1)     # [T,E]
    gate_vals, expert_idx = _top_k(probs, k)                     # [T,k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    disp_onehot = _one_hot(expert_idx, e)                        # [T,k,E]

    # --- the groups' counts before this block, and their totals ---
    before, totals = seq_counts_before(block_counts(
        disp_onehot, probs, expert_idx, b, blk, g_size))
    me = totals[:, 1] / g_size                                   # [G,E]
    ce = totals[:, 2] / g_size
    aux = e * (me * ce).sum(dim=-1).mean()
    pos = block_positions(disp_onehot, b, blk, g_size, before[:, :, 0])
    in_cap = _in_capacity(pos, cap)
    gate_vals = gate_vals * in_cap.amax(dim=-1)             # drop overflow
    routed = disp_onehot * in_cap
    xin = xt
    if experts_split:
        routed, pos = model_slice(routed, 2), model_slice(pos, 2)
        gate_vals = sum_grads_over_model(gate_vals)
        xin = sum_grads_over_model(xt)
    # a slot of the groups this rank touches: its group's place, its
    # capacity position
    slot = torch.where(pos >= 0, local[group][:, None, None] * cap + pos,
                       -1.0)
    slot_onehot = _one_hot(slot.to(torch.int32), len(touched) * cap)
    dispatch = torch.einsum("tke,tkes->tes", routed, slot_onehot).to(dt)
    combine = torch.einsum("tke,tkes->tes", gate_vals[..., None] * routed,
                           slot_onehot).to(dt)

    # --- expert computation over those slots ---
    xe = torch.einsum("tes,td->esd", dispatch, xin)              # [E,S,D]
    h = torch.einsum("esd,edf->esf", xe, p["wi"].to(dt))
    hg = (torch.einsum("esd,edf->esf", xe, p["wg"].to(dt))
          if cfg.mlp == "swiglu" else None)
    h = activate(cfg, h, hg)
    ye = torch.einsum("esf,efd->esd", h, p["wo"].to(dt))
    y = torch.einsum("tes,esd->td", combine, ye)                 # [T,D]
    if experts_split:
        y = sum_over_model(y)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], cfg, xt[None], split=shared_split,
                    gather=False)[0]
    return y.reshape(b, n, d), aux.to(torch.float32)


def block_groups(b: int, blk, g_size: int, device):
    """The routing group of each of a block's tokens ([B x n], row-major)
    where ``blk`` (start, n, total) is this block of each of the B rows of
    a [B, total] batch whose groups are ``g_size`` consecutive tokens of
    the flattened batch; and the sorted list of the groups it touches."""
    start, n, total = blk
    flat = (torch.arange(b, device=device)[:, None] * total + start +
            torch.arange(n, device=device)).reshape(-1)
    touched = sorted({g for r in range(b) for g in range(
        (r * total + start) // g_size,
        (r * total + start + n - 1) // g_size + 1)})
    return flat // g_size, touched


def block_counts(disp_onehot, probs, expert_idx, b: int, blk,
                 g_size: int) -> torch.Tensor:
    """[B, G, 3, E]: a block's part of each row's per-group sums: the
    (token, choice) pairs that chose each expert, the router's
    probabilities and the top-1 choices (``_routed_in_blocks``; G every
    group of the flattened batch)."""
    start, n, total = blk
    e = disp_onehot.shape[-1]
    n_groups = b * total // g_size
    group, _ = block_groups(b, blk, g_size, probs.device)
    rows = torch.arange(b, device=probs.device).repeat_interleave(n)
    counts = torch.zeros((b * n_groups, 3, e), device=probs.device)
    counts.index_add_(0, rows * n_groups + group, torch.stack(
        [disp_onehot.sum(1), probs, _one_hot(expert_idx[:, 0], e)], 1))
    return counts.view(b, n_groups, 3, e)


def block_positions(disp_onehot, b: int, blk, g_size: int,
                    before) -> torch.Tensor:
    """[T, k, E]: each of a block's (token, choice) pairs' capacity
    position in its expert's queue (-1 where it did not choose the expert),
    as one device's cumulative sum over the whole group gives it: the
    pairs of its group before it in this block plus ``before`` [B, G, E],
    the group's pairs in the rows and blocks before this one
    (``sharding.spmd.seq_counts_before``)."""
    start, n, total = blk
    t, k, e = disp_onehot.shape
    dev = disp_onehot.device
    group, _ = block_groups(b, blk, g_size, dev)
    rows = torch.arange(b, device=dev).repeat_interleave(n)
    local = torch.arange(t, device=dev)
    flat = rows * total + start + local % n
    # each token's first token of its (row, group) run in this block
    first = torch.clamp_min(group * g_size - (flat - local), rows * n)
    run = torch.cumsum(disp_onehot.reshape(t * k, e), dim=0)
    run = torch.cat([torch.zeros_like(run[:1]), run])
    pos = (run[1:].view(t, k, e) - run[first * k][:, None] +
           before.reshape(-1, e)[rows * before.shape[1] + group][:, None])
    return pos * disp_onehot - 1.0


__all__ = ["EXPERT_SPLIT", "init_moe", "gathers_rows", "moe_parts",
           "moe_ffn", "block_groups", "block_counts", "block_positions",
           "_capacity", "_one_hot", "_top_k"]
