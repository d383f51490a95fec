"""Shared layers in PyTorch; port of ``src/repro/models/layers.py``: the
dense initialiser, RMSNorm and LayerNorm, RoPE (full and partial rotary),
the embedding and the unembedding, the MLPs (swiglu, relu2, gelu), and
attention (plain grouped-query scores, the online-softmax flash form with
its banded sliding-window iteration, and the sublayer that picks between
them). The context-parallel flash form, which needs a mesh, comes with
ROADMAP Queue A 12.

Functions take a param dict and activations, as the reference's do; the
reference's logical-axis ``shard`` annotations are dropped (one device).
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


def mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = torch.matmul(x, p["wi"].to(dt))
    g = torch.matmul(x, p["wg"].to(dt)) if cfg.mlp == "swiglu" else None
    return torch.matmul(activate(cfg, h, g), p["wo"].to(dt))


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


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def attention_scores(q, k, v, q_positions, kv_positions, *, causal: bool,
                     window: int = 0, kv_mask=None) -> torch.Tensor:
    """Plain attention. q: [B,Sq,H,D]; k,v: [B,Skv,Hkv,D].

    GQA is computed with *grouped* products — queries reshaped to
    [B,Sq,Hkv,G,D] against unexpanded K/V, so the KV repeat is never
    materialised. Scores in f32; the probabilities are cast to q's dtype
    before the PV product, as the reference casts them."""
    b, sq, h, dh = q.shape
    hk = k.shape[2]
    g = h // hk
    dv = v.shape[-1]
    qg = q.reshape(b, sq, hk, g, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", _f32(qg), _f32(k))
    scores = scores / math.sqrt(dh)
    rel = q_positions[:, None, None, :, None] - \
        kv_positions[:, None, None, None, :]
    mask = torch.ones((b, 1, 1, sq, k.shape[1]), dtype=torch.bool,
                      device=q.device)
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


def attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Full self-attention sublayer: project, attend (flash for long
    sequences), output-project. The reference's context-parallel branch
    runs only under a mesh with a "model" axis; on one device these are its
    two other branches. Its ``kv_override`` / ``kv_positions`` /
    ``kv_mask`` arguments have no caller in either package (decode attends
    to the cache through ``attention_scores``) and are not ported."""
    q, k, v = qkv_project(p, cfg, x, positions)
    if cfg.attn_chunk_q > 0 and k.shape[1] >= cfg.attn_chunk_threshold:
        out = flash_attention(q, k, v, positions, positions, causal=causal,
                              window=cfg.window, block_q=cfg.attn_chunk_q,
                              block_kv=cfg.attn_chunk_kv)
    else:
        out = attention_scores(q, k, v, positions, positions, causal=causal,
                               window=cfg.window)
    return merge_heads(out, p["wo"])


__all__ = ["Params", "_dense_init", "init_rmsnorm", "rmsnorm",
           "init_layernorm", "layernorm",
           "rope_frequencies", "apply_rope", "init_embedding", "embed",
           "init_unembed", "unembed", "init_mlp", "activate", "mlp",
           "init_attention", "project_heads", "merge_heads", "qkv_project",
           "attention_scores", "flash_attention", "attention"]
