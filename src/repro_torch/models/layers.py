"""Shared layers in PyTorch; port of ``src/repro/models/layers.py``: the
dense initialiser, RMSNorm and LayerNorm, RoPE (full and partial rotary),
the embedding and the unembedding, the MLPs (swiglu, relu2, gelu), and
attention (plain grouped-query scores, the online-softmax flash form with
its banded sliding-window iteration, and the sublayer that picks between
them), and the context-parallel flash form, which runs under a
``DeviceMesh`` with a "model" axis.

Functions take a param dict and activations, as the reference's do; the
reference's logical-axis ``shard`` annotations are dropped. Under a mesh
(``sharding.spmd``) they run on each rank's rows with the weights whole,
or, for the MLP and attention (``split``), with this rank's part of a
tensor-parallel product over "model". The decode step's self- and
cross-attention (``decode_attention``, ``cross_decode_attention``) meet
the three cache layouts of the reference's rule sets there, the embedding
and the unembedding take a vocabulary split over "model" (``embed_part``,
``unembed``). A prefill whose sequence is split over the data axes
attends with each rank's block of queries to the keys and values gathered
over them (``attention``).
A product the reference asks in float32 of lower-precision operands
(``preferred_element_type=float32``) is an f32 product of the operands
rounded to their dtype here: products of bf16 values are exact in f32, so
the values are the reference's, at an f32 GEMM's cost.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..sharding.spmd import (combine_softmax_over_model, data_block,
                              data_whole, gather_over_model, model_axis,
                              model_slice, seq_block, seq_key_positions,
                              seq_whole, sum_grads_over_model,
                              sum_over_data, sum_over_model)
from .config import ModelConfig

Params = dict[str, Any]

MASKED = -1e30                 # score of a masked key (the reference's)
Q_PAD_POS = -(1 << 30)         # position of a padded query row
KV_PAD_POS = 1 << 30           # position of a padded key row


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


def init_layernorm(d: int, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with its statistics in f32 (the population variance, as
    ``jnp.var``), a scale and a bias; the result in x's dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(d_rot: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / d_rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (int). Rotates the leading
    ``rotary_pct`` fraction of D (GLM/Nemotron-style partial rotary)."""
    d = x.shape[-1]
    d_rot = int(d * rotary_pct)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_frequencies(d_rot, theta, x.device)             # [d_rot/2]
    angles = positions.to(torch.float32)[..., None] * freqs      # [B,S,d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x_rot.to(torch.float32), 2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rot.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   device=None) -> Params:
    return {"table": (torch.randn((vocab, d), generator=gen,
                                  dtype=torch.float32) * 0.02).to(device)}


def embed_part(table: torch.Tensor, dim, tokens: torch.Tensor,
               dtype) -> torch.Tensor:
    """``embed`` of a table that holds this model rank's contiguous run of
    the vocabulary (``dim`` 0; ``sharding.spmd.model_part``): a token
    outside the run gives zeros, and the ranks' rows are summed over
    "model", which is exact (one term is not zero). ``dim`` None: the whole
    table, as ``embed``."""
    if dim is None:
        return embed({"table": table}, tokens, dtype)
    n = table.shape[0]
    local = tokens - model_axis()[1] * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.clamp(local, 0, n - 1)]
    return sum_over_model(torch.where(inside[..., None], rows, 0.0)
                          .to(dtype))


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The rows of ``tokens``, gathered in the table's float32 and then
    cast (the reference casts the table first: the same values, but its
    gradient then sums each token's rows in the compute dtype, and a bf16
    sum over a batch's repeats of a token loses bits that a sum over half
    of them keeps, so a step on a mesh would not match one on one
    device)."""
    return p["table"][tokens].to(dtype)


def init_unembed(gen: torch.Generator, d: int, vocab: int,
                 device=None) -> Params:
    return {"w": _dense_init(gen, (d, vocab), device=device)}


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def contract_first(x: torch.Tensor, w: torch.Tensor,
                   product=_matmul) -> torch.Tensor:
    """``product(x, w)`` (x's last dim against w's first, in x's dtype by
    default). Where ``w`` holds a decode step's data shard of ``d_model``
    (``sharding.spmd.decode_part``: fewer rows than x has columns), the
    product of x's columns there, summed over the data axes."""
    xb = data_block(x, w.shape[0])
    y = product(xb, w)
    return sum_over_data(y)[0] if xb.shape[-1] != x.shape[-1] else y


def unembed(p: Params, x: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """Logits in float32 from operands rounded to x's dtype. The values are
    the reference's (a bf16 product with ``preferred_element_type=float32``:
    products of bf16 values are exact in f32), but the product here is an
    f32 GEMM standing in for that bf16 tensor-core product, so it costs an
    f32 GEMM's time. A ``w`` that holds a rank's run of the vocabulary
    gives that run's logits; one that holds its data shard of ``d_model``
    (a decode step's, ``sharding.spmd.decode_part``) takes x's columns
    there, and the partial logits are summed over the data axes before
    the softcap."""
    logits = contract_first(x, p["w"].to(x.dtype), lambda a, w: torch.matmul(
        a.to(torch.float32), w.to(torch.float32)))
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             device=None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"wi": _dense_init(gen, (d, f), device=device),
                "wg": _dense_init(gen, (d, f), device=device),
                "wo": _dense_init(gen, (f, d), device=device)}
    return {"wi": _dense_init(gen, (d, f), device=device),
            "wo": _dense_init(gen, (f, d), device=device)}


def activate(cfg: ModelConfig, h: torch.Tensor, gate=None) -> torch.Tensor:
    """The MLP's nonlinearity: silu(gate) * h (swiglu), relu(h)^2
    (Nemotron/Primer) or gelu (tanh approximation, ``jax.nn.gelu``'s
    default)."""
    if cfg.mlp == "swiglu":
        return F.silu(gate) * h
    if cfg.mlp == "relu2":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")


# the tensor dim of each leaf that a tensor-parallel product splits over
# "model" (``sharding.spmd.split_over_model``): the hidden units of the MLP,
# the heads of attention (column-parallel in, row-parallel out)
MLP_SPLIT = {"wi": 1, "wg": 1, "wo": 0}
ATTN_SPLIT = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "bq": 0, "bk": 0, "bv": 0}
# the attention's leaves that may stay whole over "model" while its query
# heads are split (``split_over_model``'s ``optional``): the K/V projections
# and their biases where the KV heads do not divide the axis or
# ``SERVING_RULES`` keeps them whole, and ``bq``, whose rule is theirs
ATTN_OPTIONAL = ("wk", "wv", "bq", "bk", "bv")


def mlp(p: Params, cfg: ModelConfig, x: torch.Tensor,
        split: bool = False, gather: bool = True) -> torch.Tensor:
    """The MLP. ``split``: ``p`` holds this rank's hidden units of the
    "model" axis (``MLP_SPLIT``), ``x`` is whole there; each rank's output
    is its part of the sum, added up over the axis. Leaves that hold a
    decode step's data shard of ``d_model`` (``sharding.spmd.decode_part``)
    contract x's columns there (``wi``, ``wg``: the hidden units summed
    over the data axes) and give this rank's output columns (``wo``),
    gathered over the data axes unless ``gather`` is False."""
    dt = x.dtype
    if split:
        x = sum_grads_over_model(x)
    xb = data_block(x, p["wi"].shape[0])
    h = torch.matmul(xb, p["wi"].to(dt))
    g = torch.matmul(xb, p["wg"].to(dt)) if cfg.mlp == "swiglu" else None
    if xb.shape[-1] != x.shape[-1]:
        h, g = sum_over_data(h, g)
    y = torch.matmul(activate(cfg, h, g), p["wo"].to(dt))
    y = sum_over_model(y) if split else y
    return data_whole(y, x.shape[-1]) if gather else y


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device=None) -> Params:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": _dense_init(gen, (d, h, dh), d, device=device),
        "wk": _dense_init(gen, (d, hk, dh), d, device=device),
        "wv": _dense_init(gen, (d, hk, dh), d, device=device),
        "wo": _dense_init(gen, (h, dh, d), h * dh, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, dh), dtype=torch.float32, device=device)
        p["bk"] = torch.zeros((hk, dh), dtype=torch.float32, device=device)
        p["bv"] = torch.zeros((hk, dh), dtype=torch.float32, device=device)
    return p


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): x [B, S, D] against w [D, H, K] in x's
    dtype."""
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(
        -1, (h, k))


def merge_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"): o [B, S, H, K] against w [H, K, D]."""
    h, k, d = w.shape
    return torch.matmul(o.flatten(-2), w.to(o.dtype).reshape(h * k, d))


def qkv_project(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    dt = x.dtype
    q = project_heads(x, p["wq"])
    k = project_heads(x, p["wk"])
    v = project_heads(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


def rank_kv_heads(k: torch.Tensor, v: torch.Tensor, n_heads: int,
                  dim: int = 2):
    """The KV heads of whole k, v [B, S, Hkv, D] (their heads on ``dim``)
    that this model rank's run of ``n_heads / tp`` query heads meets: rank
    r's head i is head ``r n_heads / tp + i`` of the layer and meets KV
    head ``(r n_heads / tp + i) // (n_heads / Hkv)`` (``attention_scores``'
    grouping). Where those KV heads are a run each of which serves an equal
    run of the rank's heads, the run itself (a slice, so grouped products
    still never repeat a KV head); where the rank's heads straddle groups
    of unequal share (12 heads on 3 KV heads, 4 ranks: rank 1's heads 3, 4
    and 5 meet KV heads 0, 1 and 1), each head's own KV head gathered."""
    _, rank, tp = model_axis()
    hl, g = n_heads // tp, n_heads // k.shape[dim]
    idx = [(rank * hl + i) // g for i in range(hl)]
    first, n = idx[0], idx[-1] - idx[0] + 1
    if hl % n == 0 and idx == [first + i // (hl // n) for i in range(hl)]:
        return k.narrow(dim, first, n), v.narrow(dim, first, n)
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(dim, sel), v.index_select(dim, sel)


def split_queries(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, kept: tuple,
                  enc_out: torch.Tensor | None = None):
    """(q, k, v) of an attention whose query heads are split over "model"
    and whose K/V projections are whole there (``split_over_model``'s
    form ``kept``, the whole leaves' names: ``wk`` and ``wv`` always, the
    rules giving every K/V leaf one divisibility), as the reference's
    partitioned program computes it. A self-attention projects K and V
    whole on every model rank (with their biases and rope, as
    ``qkv_project``) and passes them into the region through
    ``sum_grads_over_model``, so the whole K/V weights' gradient is the
    same on every rank and the gradient they pass back to x is whole. The
    cross-attention (``enc_out``, the encoder output: no bias, no rope, as
    ``_cross_attention`` projects them) projects only the KV heads this
    rank's queries meet, from its columns of the whole ``wk`` / ``wv``,
    the encoder output and the two weights entering the region. x enters
    it once, for the queries of this rank's heads (``p["wq"]``'s part, and
    its rows of a whole ``bq``, taken inside the region so that gradient
    comes back whole). Returns this rank's queries and the KV heads they
    meet (``rank_kv_heads``)."""
    dt = x.dtype
    if enc_out is None:
        k = project_heads(x, p["wk"])
        v = project_heads(x, p["wv"])
        if cfg.qkv_bias:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
        k, v = rank_kv_heads(sum_grads_over_model(k),
                             sum_grads_over_model(v), cfg.n_heads)
    else:
        enc_out = sum_grads_over_model(enc_out)
        wk, wv = rank_kv_heads(sum_grads_over_model(p["wk"]),
                               sum_grads_over_model(p["wv"]), cfg.n_heads,
                               dim=1)
        k, v = project_heads(enc_out, wk), project_heads(enc_out, wv)
    x = sum_grads_over_model(x)
    q = project_heads(x, p["wq"])
    if cfg.qkv_bias:
        bq = p["bq"]
        if "bq" in kept:
            bq = model_slice(sum_grads_over_model(bq), 0)
        q = q + bq.to(dt)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    return q, k, v


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def attention_scores(q, k, v, q_positions, kv_positions, *, causal: bool,
                     window: int = 0, kv_mask=None,
                     head_dim: int = 0) -> torch.Tensor:
    """Plain attention. q: [B,Sq,H,D]; k,v: [B,Skv,Hkv,D].

    GQA is computed with *grouped* products — queries reshaped to
    [B,Sq,Hkv,G,D] against unexpanded K/V, so the KV repeat is never
    materialised. Scores in f32; the probabilities are cast to q's dtype
    before the PV product, as the reference casts them. ``head_dim``: q, k
    and v hold this model rank's run of the ``head_dim`` columns of each
    head (a cache split over "model" on its head dim, the reference's
    fallback); the partial scores are summed over "model" before the
    scale, the mask and the softmax, and the output holds the run's
    columns."""
    b, sq, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    dv = v.shape[-1]
    qg = q.reshape(b, sq, hk, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", _f32(qg), _f32(k))
    if head_dim:
        scores = sum_over_model(scores)
    scores = scores / math.sqrt(head_dim or dh)
    mask = torch.ones((b, 1, 1, sq, k.shape[1]), dtype=torch.bool,
                      device=q.device)
    if causal or window:
        rel = q_positions[:, None, None, :, None] - \
            kv_positions[:, None, None, None, :]
    if causal:
        mask = mask & (rel >= 0)
    if window:
        mask = mask & (rel < window)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, None, :]
    scores = torch.where(mask, scores, MASKED)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, dv)


def attention_over_split_keys(q, k, v, kv_mask,
                              scale_dim: int = 0) -> torch.Tensor:
    """One query position's attention (no causal or window mask: decode)
    over keys split over "model" (a cache's slots, "seq_kv"): each rank's
    softmax statistics over its keys k, v [B, Skv/tp, Hkv, D] with their
    validity ``kv_mask`` [B, Skv/tp], combined over "model"
    (``sharding.spmd.combine_softmax_over_model``). Scores in f32, the
    probabilities cast to q's dtype before the PV product; the output
    [B, Sq, H, Dv] in q's dtype. ``scale_dim``: the head dim the scores
    are scaled by, where it is not q's (MLA's queries absorbed into its
    latent space)."""
    b, sq, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    dv = v.shape[-1]
    qg = q.reshape(b, sq, hk, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", _f32(qg), _f32(k)) / \
        math.sqrt(scale_dim or dh)
    s = torch.where(kv_mask[:, None, None, None, :], s, MASKED)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhgqk,bkhd->bhgqd", _f32(p.to(q.dtype)), _f32(v))
    out = combine_softmax_over_model(m, p.sum(dim=-1), acc)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def owned_slot(slot: int, n_local: int):
    """The index in this model rank's run of ``n_local`` cache slots of
    the global ``slot``, or None where another rank owns it."""
    rank = model_axis()[1]
    return slot - rank * n_local if slot // n_local == rank else None


def decode_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot: int, kv_mask, *,
                     dims: dict | None = None,
                     cache_dim: int | None = None) -> torch.Tensor:
    """One token's self-attention sublayer against a layer's KV cache
    [B, S, Hkv, D], which it updates in place: the new key and value go
    into ``slot`` and the query attends to every slot ``kv_mask`` marks.

    Under a mesh ``p`` holds each leaf's "model" part
    (``sharding.spmd.model_parts``) and ``dims`` the tensor dim each is
    split on there (None: whole); no leaf is gathered over "model". A
    projection split over heads gives this rank's heads, gathered whole
    unless the cache holds this rank's heads. ``cache_dim`` is the cache's
    dim split over "model" (layer-local), one of the reference's three
    layouts:

    * 2, the KV heads (``DEFAULT_RULES`` / ``LONG_CONTEXT_RULES`` where they
      divide "model"): head-parallel, each rank its own query groups;
    * 3, the head dim (the same rules where the KV heads do not divide the
      axis): each rank writes and scores its run of each head's columns,
      the partial scores summed over "model" before the mask and the
      softmax, the PV product its own columns, gathered;
    * 1, the slots (``SERVING_RULES``' "seq_kv"): the rank that owns
      ``slot`` writes it, each scores its own slots for every head, and the
      softmax statistics are combined over "model";
    * None: the whole cache on every rank.

    The output projection is row-parallel (this rank's heads, summed over
    "model") where ``wo`` is split over heads.

    Where the rows are whole on the data axes, every projection holds this
    rank's data shard of ``d_model`` (``sharding.spmd.decode_part``): the
    Q/K/V projections contract x's columns there and are summed over the
    data axes in one all-reduce before their biases are added, so the new
    key and value are whole, as the cache is there; ``wo`` gives this
    rank's columns of the output, which are gathered."""
    dims = dims or {}
    dt = x.dtype
    names, proj = ("wq", "wk", "wv"), {}
    xb = data_block(x, p["wq"].shape[0])
    if xb.shape[-1] != x.shape[-1]:
        proj = dict(zip(names, sum_over_data(
            *(project_heads(xb, p[w]) for w in names))))

    def heads(w: str, b: str, rope: bool):
        y = proj.pop(w) if proj else project_heads(x, p[w])
        if cfg.qkv_bias:
            bias = p[b]
            if dims.get(w) is not None and dims.get(b) is None:
                bias = model_slice(bias, 0)
            y = y + bias.to(dt)
        if rope:
            y = apply_rope(y, positions, cfg.rope_theta, cfg.rotary_pct)
        if cache_dim == 2:
            return y if dims.get(w) is not None else model_slice(y, 2)
        return gather_over_model(y, 2) if dims.get(w) is not None else y

    q = heads("wq", "bq", True)
    k = heads("wk", "bk", True)
    v = heads("wv", "bv", False)
    if cache_dim == 1:
        local = owned_slot(slot, k_cache.shape[1])
        if local is not None:
            k_cache[:, local] = k[:, 0]
            v_cache[:, local] = v[:, 0]
    elif cache_dim == 3:
        k_cache[:, slot] = model_slice(k[:, 0], -1)
        v_cache[:, slot] = model_slice(v[:, 0], -1)
    else:
        k_cache[:, slot] = k[:, 0]
        v_cache[:, slot] = v[:, 0]
    return _attend_cache(p, q, k_cache, v_cache, kv_mask, dims, cache_dim,
                         x.shape[-1])


def _attend_cache(p: Params, q, k_cache, v_cache, kv_mask, dims: dict,
                  cache_dim: int | None, width: int) -> torch.Tensor:
    """The query ``q`` (this rank's heads where the cache holds them,
    every head otherwise) against a cache in one of ``decode_attention``'s
    layouts, and the output projection (row-parallel where ``wo`` holds
    this rank's heads; its output columns gathered over the data axes where
    it holds a data shard of the ``width`` of ``d_model``). ``kv_mask``
    [B, S] over the whole cache's slots, or None: every slot valid."""
    if cache_dim == 1:
        if kv_mask is None:
            kv_mask = torch.ones(k_cache.shape[:2], dtype=torch.bool,
                                 device=k_cache.device)
        else:
            kv_mask = model_slice(kv_mask, 1)
        o = attention_over_split_keys(q, k_cache, v_cache, kv_mask)
    elif cache_dim == 3:
        o = gather_over_model(attention_scores(
            model_slice(q, -1), k_cache, v_cache, None, None, causal=False,
            kv_mask=kv_mask, head_dim=q.shape[-1]), -1)
    else:
        o = attention_scores(q, k_cache, v_cache, None, None, causal=False,
                             kv_mask=kv_mask)
    if dims.get("wo") is not None:
        if cache_dim != 2:
            o = model_slice(o, 2)
        return data_whole(sum_over_model(merge_heads(o, p["wo"])), width)
    if cache_dim == 2:
        o = gather_over_model(o, 2)
    return data_whole(merge_heads(o, p["wo"]), width)


def cross_decode_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                           positions: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, *, dims: dict | None = None,
                           cache_dim: int | None = None) -> torch.Tensor:
    """One token's cross-attention sublayer against a layer's cross cache
    [B, T, H, Dh] (the encoder's keys and values, every frame valid, no
    causal mask; nothing written): the query projected and roped as the
    decoder's cross-attention does it (``model._cross_attention``). Under
    a mesh ``p``, ``dims`` and ``cache_dim`` are ``decode_attention``'s:
    the cache holds this rank's heads (2), its run of each head's columns
    (3), its run of the frames (1, ``SERVING_RULES``' "seq_kv": the
    softmax statistics combined over "model") or all of it (None). A
    ``wq`` / ``wo`` that holds this rank's data shard of ``d_model``
    contracts x's columns there (summed over the data axes before the bias)
    / gives this rank's output columns (gathered), as in
    ``decode_attention``."""
    dims = dims or {}
    q = contract_first(x, p["wq"], project_heads)
    if cfg.qkv_bias:
        bias = p["bq"]
        if dims.get("wq") is not None and dims.get("bq") is None:
            bias = model_slice(bias, 0)
        q = q + bias.to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    if cache_dim == 2:
        q = q if dims.get("wq") is not None else model_slice(q, 2)
    elif dims.get("wq") is not None:
        q = gather_over_model(q, 2)
    return _attend_cache(p, q, k_cache, v_cache, None, dims, cache_dim,
                         x.shape[-1])


def flash_attention(q, k, v, q_positions, kv_positions, *, causal: bool,
                    window: int = 0, kv_mask=None,
                    block_q: int = 1024, block_kv: int = 1024,
                    q_block_start: int = 0) -> torch.Tensor:
    """Flash attention as plain PyTorch: an online softmax over KV blocks
    inside a loop over Q blocks, with the reference's blocking, padding
    positions and masking constants, so it computes what the reference's
    computes in the same order. Peak memory O(block_q * block_kv) per head.

    For causal sliding-window attention only the diagonal band of
    ``(block_q + window - 2) // block_kv + 2`` KV blocks is visited; an
    offset outside [0, nkv) visits the clipped block with every key masked,
    as the reference's does, so no block is counted twice. The reference
    caps the band at ``nkv`` offsets from its first, which leaves out the
    diagonal blocks when the band is longer than the sequence (hymba's 2048
    window at 2048 positions in blocks of 1024: q block 0 sees no valid
    block); the port keeps the whole band and is the reference's wherever
    the cap does not bind (ROADMAP Queue C).

    Padded keys are always masked. The reference masks them only through
    their positions, which a causal or windowed mask catches and a
    non-causal one does not: there, without a ``kv_mask``, its zero keys
    enter the softmax (whisper's encoder at a frame count at or above the
    chunk threshold and off a multiple of ``block_kv``); the port is the
    reference wherever no key is padded or the mask is causal (ROADMAP
    Queue C)."""
    b, sq, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk                    # grouped GQA: no KV repeat materialised
    dv = v.shape[-1]               # v head dim may differ (MLA)
    skv = k.shape[1]
    block_q = min(block_q, sq)
    block_kv = min(block_kv, skv)
    pad_q = (-sq) % block_q
    pad_kv = (-skv) % block_kv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = F.pad(q_positions, (0, pad_q), value=Q_PAD_POS)
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
        kv_positions = F.pad(kv_positions, (0, pad_kv), value=KV_PAD_POS)
        if kv_mask is None:
            kv_mask = torch.ones((b, skv), dtype=torch.bool, device=q.device)
        kv_mask = F.pad(kv_mask, (0, pad_kv), value=False)
    nq = q.shape[1] // block_q
    nkv = k.shape[1] // block_kv
    scale = 1.0 / math.sqrt(dh)

    qb = q.reshape(b, nq, block_q, hk, g, dh)
    qpb = q_positions.reshape(b, nq, block_q)
    kb = k.reshape(b, nkv, block_kv, hk, dh)
    vb = v.reshape(b, nkv, block_kv, hk, dv)
    kpb = kv_positions.reshape(b, nkv, block_kv)
    kmb = (kv_mask.reshape(b, nkv, block_kv) if kv_mask is not None
           else torch.ones((b, nkv, block_kv), dtype=torch.bool,
                           device=q.device))

    banded = bool(causal and window)
    n_band = (block_q + window - 2) // block_kv + 2 if banded else nkv

    outs = []
    for qi in range(nq):
        q_i = _f32(qb[:, qi])       # [B, bq, Hk, G, D]
        qp_i = qpb[:, qi]           # [B, bq]
        m = torch.full((b, hk, g, block_q), MASKED, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hk, g, block_q), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hk, g, block_q, dv), dtype=torch.float32,
                          device=q.device)
        for off in range(n_band):
            if banded:
                base = ((q_block_start + qi) * block_q - (window - 1)) \
                    // block_kv
                kj_raw = base + off
                kj = min(max(kj_raw, 0), nkv - 1)
                block_valid = 0 <= kj_raw < nkv
            else:
                kj, block_valid = off, True
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i,
                             _f32(kb[:, kj])) * scale
            rel = qp_i[:, None, None, :, None] - \
                kpb[:, kj][:, None, None, None, :]
            msk = kmb[:, kj][:, None, None, None, :]
            if not block_valid:
                msk = torch.zeros_like(msk)
            if causal:
                msk = msk & (rel >= 0)
            if window:
                msk = msk & (rel < window)
            s = torch.where(msk, s, MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", _f32(p.to(q.dtype)), _f32(vb[:, kj]))
            m = m_new
        out_i = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out_i.to(q.dtype))          # [B, Hk, G, bq, Dv]
    out = torch.stack(outs, dim=3)              # [B, Hk, G, nq, bq, Dv]
    out = out.reshape(b, hk, g, nq * block_q, dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, nq * block_q, h, dv)
    return out[:, :sq]


def _context_parallel_flash(cfg: ModelConfig, q, k, v, q_positions,
                            kv_positions, *, causal: bool,
                            q_start: int = 0) -> torch.Tensor:
    """Context-parallel flash attention (the reference's ``shard_map``):
    each rank of the "model" axis attends with its own run of ``S / tp``
    query positions to every key (K, V and their positions whole on each
    rank), its blocks numbered from ``rank_on_model * blocks_per_shard`` so
    it visits the band of its own positions; the ranks' outputs are
    gathered along the sequence. Taken under the reference's condition
    (among others, the head count does not divide the model axis: hymba's
    25); where the heads divide it, the attention runs head-parallel
    instead (``attention(..., split=True)``). Where q holds a data rank's
    block of the sequence from position ``q_start``, the model axis splits
    that block, its blocks numbered from the block's start."""
    _, rank, tp = model_axis()
    s_local = q.shape[1] // tp
    block_q = min(cfg.attn_chunk_q, s_local)
    blocks_per_shard = max(s_local // cfg.attn_chunk_q, 1)
    q, k, v = (sum_grads_over_model(t) for t in (q, k, v))
    rows = slice(rank * s_local, (rank + 1) * s_local)
    out = flash_attention(
        q[:, rows], k, v, q_positions[:, rows], kv_positions, causal=causal,
        window=cfg.window, block_q=block_q, block_kv=cfg.attn_chunk_kv,
        q_block_start=q_start // block_q + rank * blocks_per_shard)
    return gather_over_model(out, 1)


def _block_q_of(chunk: int, n: int) -> int:
    """The query block of a flash attention over a data rank's block of
    ``n`` query positions: ``min(chunk, n)`` where it divides ``n`` (so the
    block's start is a whole number of query blocks and a windowed mask's
    band is the right one), else their greatest common divisor."""
    bq = min(chunk, n)
    return bq if n % bq == 0 else math.gcd(n, chunk)


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              split: bool | tuple = False) -> torch.Tensor:
    """Full self-attention sublayer: project, attend (flash for long
    sequences), output-project. Under a mesh with a "model" axis the
    reference's condition picks the context-parallel form: flash,
    windowed, the heads not a multiple of the model axis, and the sequence
    one, at 128 positions or more a shard (a model axis of 1 divides every
    head count). The reference's ``kv_override``
    / ``kv_positions`` / ``kv_mask`` arguments have no caller in either
    package (decode attends to the cache through ``attention_scores``) and
    are not ported. ``split`` (``sharding.spmd.split_over_model``'s form
    with ``ATTN_SPLIT`` and ``ATTN_OPTIONAL``): True, ``p`` holds this
    rank's heads of the "model" axis, query and key-value heads both, so
    each rank's query groups meet their own key-value heads; a tuple of
    the leaves kept whole, ``p`` holds this rank's query heads and whole
    K/V projections (``split_queries``: K and V projected whole on every
    model rank, as the reference's partitioned program does). Either way
    x is whole over "model" and each rank's output is its part of the sum,
    added up over the axis. False: the whole attention on every model
    rank (the heads do not divide the axis: hymba's 25).

    Where x is a data rank's block of the sequence (a prefill under
    ``sharding.spmd.sequence``, ``positions`` the block's), the block's
    queries attend to the keys and values gathered over the data axes
    (``seq_whole``); the reference's condition reads the whole sequence's
    length, and the context-parallel form splits the block over "model"."""
    if isinstance(split, tuple):
        q, k, v = split_queries(p, cfg, x, positions, split)
    else:
        if split:
            x = sum_grads_over_model(x)
        q, k, v = qkv_project(p, cfg, x, positions)
    k, v = seq_whole(k), seq_whole(v)
    kv_positions = seq_key_positions(positions)
    blk = seq_block()
    q_start, flash = 0, {}
    if blk is not None:
        q_start = blk[0]
        bq = _block_q_of(cfg.attn_chunk_q, q.shape[1])
        flash = {"block_q": bq, "q_block_start": q_start // bq}
    s = k.shape[1]
    use_flash = cfg.attn_chunk_q > 0 and s >= cfg.attn_chunk_threshold
    axis = model_axis()
    tp = axis[2] if axis is not None and not split else 1
    if use_flash and tp > 1 and cfg.window > 0 and cfg.n_heads % tp and \
            s % tp == 0 and s // tp >= 128 and q.shape[1] % tp == 0:
        out = _context_parallel_flash(cfg, q, k, v, positions, kv_positions,
                                      causal=causal, q_start=q_start)
    elif use_flash:
        out = flash_attention(q, k, v, positions, kv_positions,
                              causal=causal, window=cfg.window,
                              **{"block_q": cfg.attn_chunk_q, **flash},
                              block_kv=cfg.attn_chunk_kv)
    else:
        out = attention_scores(q, k, v, positions, kv_positions,
                               causal=causal, window=cfg.window)
    out = merge_heads(out, p["wo"])
    return sum_over_model(out) if split else out


__all__ = ["Params", "_dense_init", "init_rmsnorm", "rmsnorm",
           "init_layernorm", "layernorm",
           "rope_frequencies", "apply_rope", "init_embedding", "embed",
           "init_unembed", "unembed", "init_mlp", "activate", "mlp",
           "MLP_SPLIT", "ATTN_SPLIT", "ATTN_OPTIONAL",
           "init_attention", "project_heads", "merge_heads", "qkv_project",
           "rank_kv_heads", "split_queries",
           "attention_scores", "attention_over_split_keys", "owned_slot",
           "decode_attention", "cross_decode_attention", "embed_part",
           "flash_attention", "attention"]
