"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434) in PyTorch;
port of ``src/repro/models/mla.py``.

K/V are compressed into a low-rank latent c_kv = W_dkv x (kv_lora_rank
wide) plus a single shared RoPE key head; per-head keys/values are
re-expanded with W_uk / W_uv. The cache stores only (c_kv, k_rope) —
(512+64) floats per token for V2-Lite instead of 2*H*Dh.

Queries split into a NoPE part (matched against the expanded no-rope keys)
and a RoPE part (matched against the shared rope key, broadcast across the
heads). The softmax scale comes from the concatenated nope + rope head dim;
the value head dim may differ from the key's. V2-Lite projects q directly
(q_lora_rank = 0).

Under a mesh (``sharding.spmd``) the heads run tensor-parallel over
"model" where they divide it (``MLA_SPLIT``): ``wq`` (or ``wq_b``),
``wk_b`` and ``wv_b`` hold this rank's heads and ``wo`` is row-parallel,
while ``wq_a`` and ``wkv_a``, whole over "model" by their specs, run on
every rank and their outputs (the latent, the rope key, the query's
low-rank input) enter the region, their gradients summed over "model".
A decode step against a cache split on its slots over "model"
(``SERVING_RULES``) holds this rank's heads and only its own slots: it
absorbs ``wk_b`` into its heads' queries, gathers every head's absorbed
queries (``[B, 1, H, r + dr]``, small), scores them against its slots in
the latent space, combines the softmax statistics over "model" and
expands its own heads' latent outputs with ``wv_b`` (``mla_decode``); no
cache entry and no weight moves. A decode step whose rows are whole on the
data axes (``LONG_CONTEXT_RULES``' batch of 1), where every data rank
holds the whole cache, expands only its data rank's block of the slots
into keys and values and attends over them, the softmax statistics
combined over the data axes in data order (``_attend_data_slots``), as the
reference's partitioned program splits the expansion over "data" by
slots.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import (Params, _dense_init, apply_rope,
                     attention_over_split_keys, attention_scores,
                     contract_first, flash_attention, merge_heads,
                     owned_slot, project_heads)
from ..sharding.spmd import (combine_softmax_over_data, data_slice,
                              data_slices, data_whole, gather_over_model,
                              model_slice, seq_key_positions, seq_whole,
                              sum_grads_over_model, sum_over_model)

# the tensor dim of each leaf that the heads split over "model"
# (``sharding.spmd.split_over_model``), and the leaves whole there
MLA_SPLIT = {"wq": 1, "wq_b": 1, "wk_b": 1, "wv_b": 1, "wo": 0}
MLA_WHOLE = ("wq_a", "wkv_a")


def init_mla(gen: torch.Generator, cfg: ModelConfig, device=None) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    dn, dv = cfg.nope_head_dim, cfg.v_head_dim
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = _dense_init(gen, (d, cfg.q_lora_rank), device=device)
        p["wq_b"] = _dense_init(gen, (cfg.q_lora_rank, h, dn + dr),
                                cfg.q_lora_rank, device=device)
    else:
        p["wq"] = _dense_init(gen, (d, h, dn + dr), d, device=device)
    p["wkv_a"] = _dense_init(gen, (d, r + dr), device=device)  # c_kv|k_rope
    p["wk_b"] = _dense_init(gen, (r, h, dn), r, device=device)
    p["wv_b"] = _dense_init(gen, (r, h, dv), r, device=device)
    p["wo"] = _dense_init(gen, (h, dv, d), h * dv, device=device)
    return p


def mla_compress(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """x -> (c_kv [B,S,r], k_rope [B,S,1,dr]): what the cache stores."""
    kv_a = contract_first(x, p["wkv_a"])
    c_kv, k_rope = torch.split(kv_a, [cfg.kv_lora_rank, cfg.rope_head_dim],
                               dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_queries(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, split: bool = False):
    """(q_nope, q_rope) of the heads ``p`` holds; ``split``: this rank's
    heads of a tensor-parallel product, whose input (x, or ``wq_a``'s
    output) is whole over "model"."""
    if cfg.q_lora_rank:
        qa = contract_first(x, p["wq_a"])
        q = project_heads(sum_grads_over_model(qa) if split else qa,
                          p["wq_b"])
    else:
        q = contract_first(sum_grads_over_model(x) if split else x, p["wq"],
                           project_heads)
    q_nope, q_rope = torch.split(
        q, [cfg.nope_head_dim, cfg.rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _expand(p: Params, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope):
    """(q, k, v) of the heads: keys and values expanded from the latent,
    the rope key shared by every head."""
    k_nope = project_heads(c_kv, p["wk_b"])
    v = project_heads(c_kv, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3],
                                         cfg.rope_head_dim)], dim=-1)
    return q, k, v


def mla_attend(p: Params, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope,
               q_positions, kv_positions, *, causal: bool = True,
               kv_mask=None) -> torch.Tensor:
    """Attention over the compressed cache: keys and values expanded from
    the latent, the rope key shared by every head."""
    q, k, v = _expand(p, cfg, q_nope, q_rope, c_kv, k_rope)
    return _attend(p, cfg, q, k, v, q_positions, kv_positions,
                   causal=causal, kv_mask=kv_mask)


def _attend(p: Params, cfg: ModelConfig, q, k, v, q_positions,
            kv_positions, *, causal: bool, kv_mask=None) -> torch.Tensor:
    """The heads' attention of expanded q, k, v (flash for long key
    sequences) and the output projection."""
    skv = k.shape[1]
    if cfg.attn_chunk_q > 0 and skv >= cfg.attn_chunk_threshold:
        out = flash_attention(q, k, v, q_positions, kv_positions,
                              causal=causal, kv_mask=kv_mask,
                              block_q=cfg.attn_chunk_q,
                              block_kv=cfg.attn_chunk_kv)
    else:
        out = attention_scores(q, k, v, q_positions, kv_positions,
                               causal=causal, kv_mask=kv_mask)
    return merge_heads(out, p["wo"])


def mla_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, causal: bool = True,
                  split: bool = False) -> torch.Tensor:
    """Training / prefill path (self-attention, no external cache).
    ``split``: ``p`` holds this rank's heads (``MLA_SPLIT``) and x is whole
    over "model"; each rank's output is its part of the sum, added up over
    the axis. Where x is a data rank's block of the sequence (a prefill
    under ``sharding.spmd.sequence``, ``positions`` the block's), the rank
    compresses and expands its own positions only, as the reference's
    program keeps the latent and the expanded keys and values split by
    "seq", and its queries attend to the expanded keys and values gathered
    over the data axes."""
    q_nope, q_rope = mla_queries(p, cfg, x, positions, split)
    c_kv, k_rope = mla_compress(p, cfg, x, positions)
    if split:
        c_kv, k_rope = sum_grads_over_model(c_kv), sum_grads_over_model(
            k_rope)
    q, k, v = _expand(p, cfg, q_nope, q_rope, c_kv, k_rope)
    out = _attend(p, cfg, q, seq_whole(k), seq_whole(v), positions,
                  seq_key_positions(positions), causal=causal)
    return sum_over_model(out) if split else out


def _absorbed_over_split_slots(p: Params, cfg: ModelConfig, q_nope, q_rope,
                               c_kv, k_rope, kv_mask) -> torch.Tensor:
    """This rank's heads' attention outputs [B, 1, H/tp, dv] when it holds
    its heads' weights and only its run of the cache's slots: its queries
    absorbed into the latent (``q_nope @ wk_b^T``, ``[B, 1, H/tp, r]``)
    and gathered over "model" with the rope queries, every head scored
    against this rank's slots (one latent key head of ``r + dr`` columns,
    scaled as the expanded heads' ``dn + dr``), the softmax statistics
    combined over "model", and this rank's heads' latent outputs expanded
    by ``wv_b``."""
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p["wk_b"].to(q_nope.dtype))
    q = gather_over_model(torch.cat([q_lat, q_rope], dim=-1), 2)
    k = torch.cat([c_kv[:, :, None, :], k_rope], dim=-1)     # [B,S,1,r+dr]
    o_lat = attention_over_split_keys(
        q, k, c_kv[:, :, None, :], kv_mask,
        scale_dim=cfg.nope_head_dim + cfg.rope_head_dim)     # [B,1,H,r]
    o_lat = model_slice(o_lat, 2)
    return torch.einsum("bshr,rhv->bshv", o_lat, p["wv_b"].to(o_lat.dtype))


def mla_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, c_kv_cache: torch.Tensor,
               k_rope_cache: torch.Tensor, slot: int, kv_positions,
               kv_mask, *, cache_dim: int | None = None,
               dims: dict | None = None) -> torch.Tensor:
    """One token's MLA sublayer against a layer's compressed cache
    (c_kv [B, S, r], k_rope [B, S, 1, dr]), which it updates in place: the
    token's latent and rope key go into ``slot`` and the query attends to
    every slot ``kv_mask`` marks. ``cache_dim`` 1: the cache holds this
    model rank's run of the slots ("seq_kv" over "model",
    ``SERVING_RULES``): the rank that owns ``slot`` writes it, each scores
    its own slots, and the softmax statistics are combined over "model".
    Under a mesh ``p`` holds each leaf's "model" part
    (``sharding.spmd.model_parts``) and ``dims`` the tensor dim each is
    split on there: where ``wo`` holds this rank's heads, so do the other
    head leaves (``MLA_SPLIT``), the heads attend on this rank (against a
    cache split on its slots through their absorbed queries) and the
    output is summed over "model". Where the rows are whole on the data
    axes, ``wq`` (or ``wq_a``) and ``wkv_a`` contract x's columns of their
    data shard of ``d_model`` (summed over the data axes) and ``wo`` gives
    this rank's output columns (gathered); ``wq_b``, ``wk_b`` and ``wv_b``
    have no data shard; each data rank expands and attends over its block
    of the slots (``_attend_data_slots``)."""
    split = (dims or {}).get("wo") is not None
    q_nope, q_rope = mla_queries(p, cfg, x, positions)
    c_kv, k_rope = mla_compress(p, cfg, x, positions)
    if cache_dim == 1:
        local = owned_slot(slot, c_kv_cache.shape[1])
        if local is not None:
            c_kv_cache[:, local] = c_kv[:, 0]
            k_rope_cache[:, local] = k_rope[:, 0]
        mask = model_slice(kv_mask, 1)
        if split:
            return sum_over_model(merge_heads(_absorbed_over_split_slots(
                p, cfg, q_nope, q_rope, c_kv_cache, k_rope_cache, mask),
                p["wo"]))
        q, k, v = _expand(p, cfg, q_nope, q_rope, c_kv_cache, k_rope_cache)
        return merge_heads(attention_over_split_keys(q, k, v, mask), p["wo"])
    c_kv_cache[:, slot] = c_kv[:, 0]
    k_rope_cache[:, slot] = k_rope[:, 0]
    if data_slices(c_kv_cache.shape[1]):
        out = _attend_data_slots(p, cfg, q_nope, q_rope, c_kv_cache,
                                 k_rope_cache, kv_mask)
    else:
        out = mla_attend(p, cfg, q_nope, q_rope, c_kv_cache, k_rope_cache,
                         positions, kv_positions, causal=False,
                         kv_mask=kv_mask)
    return data_whole(sum_over_model(out) if split else out, x.shape[-1])


def _attend_data_slots(p: Params, cfg: ModelConfig, q_nope, q_rope, c_kv,
                       k_rope, kv_mask) -> torch.Tensor:
    """The heads' attention over a cache that every data rank holds whole
    (the rows whole on the data axes): this data rank expands its block of
    about ``S / dp`` slots only (``data_slice``) and scores the
    token against them, the softmax statistics combined over the data axes
    in data order; then the output projection."""
    q, k, v = _expand(p, cfg, q_nope, q_rope, data_slice(c_kv, 1),
                      data_slice(k_rope, 1))
    return merge_heads(attention_over_split_keys(
        q, k, v, data_slice(kv_mask, 1), combine=combine_softmax_over_data),
        p["wo"])


__all__ = ["MLA_SPLIT", "MLA_WHOLE", "init_mla", "mla_compress",
           "mla_queries", "mla_attend", "mla_attention", "mla_decode"]
