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
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import (Params, _dense_init, apply_rope, attention_scores,
                     flash_attention, merge_heads, project_heads)


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
    kv_a = torch.matmul(x, p["wkv_a"].to(x.dtype))
    c_kv, k_rope = torch.split(kv_a, [cfg.kv_lora_rank, cfg.rope_head_dim],
                               dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope


def mla_queries(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    if cfg.q_lora_rank:
        qa = torch.matmul(x, p["wq_a"].to(x.dtype))
        q = project_heads(qa, p["wq_b"])
    else:
        q = project_heads(x, p["wq"])
    q_nope, q_rope = torch.split(
        q, [cfg.nope_head_dim, cfg.rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_attend(p: Params, cfg: ModelConfig, q_nope, q_rope, c_kv, k_rope,
               q_positions, kv_positions, *, causal: bool = True,
               kv_mask=None) -> torch.Tensor:
    """Attention over the compressed cache: keys and values expanded from
    the latent, the rope key shared by every head."""
    k_nope = project_heads(c_kv, p["wk_b"])
    v = project_heads(c_kv, p["wv_b"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3],
                                         cfg.rope_head_dim)], dim=-1)
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
                  positions: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Training / prefill path (self-attention, no external cache)."""
    q_nope, q_rope = mla_queries(p, cfg, x, positions)
    c_kv, k_rope = mla_compress(p, cfg, x, positions)
    return mla_attend(p, cfg, q_nope, q_rope, c_kv, k_rope,
                      positions, positions, causal=causal)


__all__ = ["init_mla", "mla_compress", "mla_queries", "mla_attend",
           "mla_attention"]
