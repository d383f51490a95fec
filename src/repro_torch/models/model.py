"""Model facade in PyTorch; port of ``src/repro/models/model.py`` for every
decoder-only family (dense and MoE decoders, MLA, Mamba-only, the parallel
attention + Mamba hybrid, and the VLM backbone with its patch prefix):
init, forward, the chunked next-token loss, the KV/state caches, the
one-token decode step and the fused prefill.

``Model`` is an ``nn.Module`` whose parameters carry the reference's tree
paths as names (``embed.table``, ``dense_blocks.<i>.mlp.wi``,
``blocks.<i>.attn.wq``, ``blocks.<i>.mlp.shared.wo``, ``ln_f.scale``,
``unembed.w``). The reference stacks the blocks on a leading layer axis and
scans over it; the port keeps one module per layer and loops
(``models/convert.py`` moves parameters between the two layouts). The
caches keep the reference's layout (``{"scan": {name: [L, ...]}, "dense":
[{name: [1, ...]}]}``), and ``decode_step`` writes the new token's entries
into them in place. ``remat="full"`` wraps each block and each
cross-entropy chunk in ``torch.utils.checkpoint`` (non-reentrant), where
the reference used ``jax.checkpoint``.

The encoder-decoder family (whisper) and ``remat="dots"`` wait for the next
slice (ROADMAP Queue A 14b) and raise.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import ssm as SSM
from ..utils.device import resolve_device
from .config import ModelConfig

Params = dict[str, Any]

_NEXT = "ROADMAP Queue A 14b (whisper's encoder-decoder and remat='dots')"


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"repro_torch models implement the decoder-only families; "
            f"{cfg.name} is 'encdec' (layernorm, the encoder, "
            f"cross-attention, the cross-KV cache): {_NEXT}")
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported (only 'none' and 'full'): "
            f"{_NEXT}")


class _Tree(nn.Module):
    """A nested parameter dict as a module: each tensor becomes a parameter
    and each dict a submodule under its key, so parameter names are the
    tree's paths."""

    def __init__(self, tree: Params):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> Params:
        out: Params = dict(self._parameters)
        for k, m in self._modules.items():
            out[k] = m.tree()
        return out


# ---------------------------------------------------------------------------
# per-layer init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, moe_layer: bool,
                device) -> Params:
    p: Params = {"ln1": L.init_rmsnorm(cfg.d_model, device),
                 "ln2": L.init_rmsnorm(cfg.d_model, device)}
    if cfg.uses_attention:
        if cfg.attention == "mla":
            p["attn"] = MLA.init_mla(gen, cfg, device)
        else:
            p["attn"] = L.init_attention(gen, cfg, device)
    if cfg.uses_ssm:
        p["ssm"] = SSM.init_mamba(gen, cfg, device)
        if cfg.family == "ssm":
            del p["ln2"]     # mamba-only blocks have a single norm
    if cfg.family != "ssm":
        if moe_layer:
            p["mlp"] = MOE.init_moe(gen, cfg, device)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, device=device)
    return p


# ---------------------------------------------------------------------------
# block forward (training / prefill: full sequences)
# ---------------------------------------------------------------------------

def _mixer(p: Params, cfg: ModelConfig, x, positions, *, causal=True):
    """Attention and/or SSM sublayer output at full sequence length (the
    hybrid sums the two heads, attention first)."""
    y = None
    if cfg.uses_attention:
        if cfg.attention == "mla":
            y = MLA.mla_attention(p["attn"], cfg, x, positions, causal=causal)
        else:
            y = L.attention(p["attn"], cfg, x, positions, causal=causal)
    if cfg.uses_ssm:
        ys = SSM.mamba_forward(p["ssm"], cfg, x)
        y = ys if y is None else y + ys
    return y


def block_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, moe_layer: bool,
                  causal: bool = True):
    """Pre-norm residual block. Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + _mixer(p, cfg, L.rmsnorm(p["ln1"], x), positions, causal=causal)
    if cfg.family == "ssm":
        return x, aux
    h = L.rmsnorm(p["ln2"], x)
    if moe_layer:
        y, aux = MOE.moe_ffn(p["mlp"], cfg, h)
    else:
        y = L.mlp(p["mlp"], cfg, h)
    return x + y, aux


def _remat(fn, cfg: ModelConfig):
    if cfg.remat == "none":
        return fn

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


class Model(nn.Module):
    """Port of the reference's ``Model`` for the decoder-only families.

    It is built on ``device``, the card unless the caller passes
    ``device="cpu"`` (``utils/device.resolve_device``). Parameters are made
    at construction from ``seed`` with a CPU ``torch.Generator`` and then
    moved to ``device``, so a seed gives the same weights on every device
    (the reference draws its own from a ``jax.random`` key; the two give
    different numbers, so tests carry the reference's parameters across
    with ``convert.load_reference_params``).
    """

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator()
        gen.manual_seed(seed)
        self.embed = _Tree(L.init_embedding(gen, cfg.vocab_size,
                                            cfg.d_model, dev))
        n_dense = cfg.first_dense_layers if cfg.is_moe else 0
        self.dense_blocks = nn.ModuleList(
            _Tree(_init_block(gen, cfg, False, dev)) for _ in range(n_dense))
        self.blocks = nn.ModuleList(
            _Tree(_init_block(gen, cfg, cfg.is_moe, dev))
            for _ in range(cfg.n_layers - n_dense))
        self.ln_f = _Tree(L.init_rmsnorm(cfg.d_model, dev))
        self.unembed = _Tree(L.init_unembed(gen, cfg.d_model,
                                            cfg.vocab_size, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # ---------------- parameter trees ----------------
    def params(self) -> Params:
        """The parameters as the reference's nested dict, the blocks as a
        list (one dict per layer) and ``dense_blocks`` where there are
        any."""
        tree: Params = {"embed": self.embed.tree()}
        if len(self.dense_blocks):
            tree["dense_blocks"] = [b.tree() for b in self.dense_blocks]
        tree["blocks"] = [b.tree() for b in self.blocks]
        tree["ln_f"] = self.ln_f.tree()
        tree["unembed"] = self.unembed.tree()
        return tree

    # ---------------- forward (training / prefill) ----------------
    def forward(self, tokens: torch.Tensor, params: Params | None = None, *,
                extra: dict | None = None):
        """tokens [B, S_text] -> (hidden [B, S_total, D], aux loss).

        extra: {"patches": [B, n_img, D]} for the VLM, prepended to the
        text embeddings."""
        cfg = self.cfg
        params = self.params() if params is None else params
        dt = cfg.compute_dtype
        x = L.embed(params["embed"], tokens, dt)
        if cfg.family == "vlm":
            x = torch.cat([extra["patches"].to(dt), x], dim=1)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for moe_layer, stack in ((False, params.get("dense_blocks", [])),
                                 (cfg.is_moe, params["blocks"])):
            fn = _remat(lambda p, x_, moe=moe_layer: block_forward(
                p, cfg, x_, positions, moe_layer=moe), cfg)
            for p in stack:
                x, aux = fn(p, x)
                aux_total = aux_total + aux
        x = L.rmsnorm(params["ln_f"], x)
        return x, aux_total

    def loss(self, batch: dict, chunk: int = 512,
             params: Params | None = None) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy, computed in sequence chunks so the f32
        logits tensor never exceeds [B, chunk, V]; plus 0.01 x the MoE aux
        loss. The VLM's image positions carry no labels."""
        cfg = self.cfg
        params = self.params() if params is None else params
        if cfg.cast_params_bf16:
            dt = cfg.compute_dtype
            params = _map_tree(lambda t: t.to(dt) if t.dtype == torch.float32
                               else t, params)
        x, aux = self.forward(batch["tokens"], params,
                              extra={k: v for k, v in batch.items()
                                     if k == "patches"})
        if cfg.family == "vlm":
            x = x[:, cfg.n_image_tokens:]
        ce, n_valid = self.ce_loss(x, batch["labels"], params, chunk)
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "tokens": n_valid}

    def ce_loss(self, x: torch.Tensor, labels: torch.Tensor, params: Params,
                chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
        """Mean next-token cross-entropy of hidden states x [B, S, D] over
        the labels >= 0, one sequence chunk of logits at a time; returns
        (ce, number of valid labels)."""
        cfg = self.cfg
        b, s, d = x.shape
        chunk = min(chunk, s)
        pad = (-s) % chunk
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        unembed_c = {"w": params["unembed"]["w"].to(cfg.compute_dtype)}

        def ce_chunk(xi, li):
            logits = L.unembed(unembed_c, xi, cfg.logit_softcap)
            logz = torch.logsumexp(logits, dim=-1)
            idx = torch.clamp_min(li, 0).long()[..., None]
            gold = torch.gather(logits, -1, idx)[..., 0]
            valid = li >= 0
            ce = torch.where(valid, logz - gold, 0.0)
            return ce.sum(), valid.sum()

        fn = _remat(ce_chunk, cfg)
        ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        n_valid = torch.zeros((), dtype=torch.int64, device=x.device)
        for c0 in range(0, x.shape[1], chunk):
            ce_c, nv = fn(x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
            ce_sum = ce_sum + ce_c
            n_valid = n_valid + nv
        return ce_sum / torch.clamp_min(n_valid, 1), n_valid

    # ---------------- serving ----------------
    def init_cache(self, batch: int, max_len: int) -> Params:
        """Per-layer caches sized for the serving context, stacked as the
        reference stacks them: attention keys and values (MLA: the latent
        and the rope key) of ``min(window, max_len)`` slots when the
        attention is windowed (a ring buffer), else ``max_len``; the SSM
        layers' conv window and f32 state."""
        cfg = self.cfg
        dt, dev = cfg.compute_dtype, self.device
        n_dense = len(self.dense_blocks)
        n_scan = len(self.blocks)
        kv_len = min(cfg.window, max_len) if cfg.window else max_len

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def attn_cache(n):
            if not cfg.uses_attention:
                return {}
            if cfg.attention == "mla":
                return {"c_kv": zeros(n, batch, kv_len, cfg.kv_lora_rank),
                        "k_rope": zeros(n, batch, kv_len, 1,
                                        cfg.rope_head_dim)}
            return {"k": zeros(n, batch, kv_len, cfg.n_kv_heads, cfg.d_head),
                    "v": zeros(n, batch, kv_len, cfg.n_kv_heads, cfg.d_head)}

        def ssm_cache(n):
            if not cfg.uses_ssm:
                return {}
            c = SSM.init_mamba_cache(cfg, batch, dt, dev)
            return {k: zeros(n, *v.shape, dtype=v.dtype)
                    for k, v in c.items()}

        cache: Params = {"scan": {**attn_cache(n_scan), **ssm_cache(n_scan)}}
        if n_dense:
            cache["dense"] = [{**attn_cache(1), **ssm_cache(1)}
                              for _ in range(n_dense)]
        return cache

    def _cache_positions(self, b: int, kv_len: int, pos: int, device):
        """Absolute positions and validity of the cache slots. In a ring
        buffer (sliding window) slot i holds the token whose position is
        congruent to i mod window and <= pos."""
        cfg = self.cfg
        idx = torch.arange(kv_len, device=device)
        if cfg.window and kv_len == cfg.window:
            cur_slot = pos % cfg.window
            base = (pos // cfg.window) * cfg.window
            abs_pos = torch.where(idx <= cur_slot, base + idx,
                                  base - cfg.window + idx)
            valid = (abs_pos >= 0) & (abs_pos <= pos)
        else:
            abs_pos = idx
            valid = idx <= pos
        return abs_pos.expand(b, kv_len), valid.expand(b, kv_len)

    def _decode_mixer(self, p: Params, x: torch.Tensor, pos: int,
                      layer_cache: Params, *, kv_len: int) -> torch.Tensor:
        """One-token mixer step against one layer's cache, which it updates
        in place. x: [B, 1, D]."""
        cfg = self.cfg
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        y = None
        if cfg.uses_attention:
            slot = pos % cfg.window if cfg.window else pos
            if slot >= kv_len:
                raise ValueError(f"position {pos} is beyond the cache's "
                                 f"{kv_len} slots")
            kv_pos, kv_mask = self._cache_positions(b, kv_len, pos, x.device)
            if cfg.attention == "mla":
                q_nope, q_rope = MLA.mla_queries(p["attn"], cfg, x, positions)
                c_kv, k_rope = MLA.mla_compress(p["attn"], cfg, x, positions)
                layer_cache["c_kv"][:, slot] = c_kv[:, 0]
                layer_cache["k_rope"][:, slot] = k_rope[:, 0]
                y = MLA.mla_attend(p["attn"], cfg, q_nope, q_rope,
                                   layer_cache["c_kv"],
                                   layer_cache["k_rope"], positions, kv_pos,
                                   causal=False, kv_mask=kv_mask)
            else:
                q, k, v = L.qkv_project(p["attn"], cfg, x, positions)
                layer_cache["k"][:, slot] = k[:, 0]
                layer_cache["v"][:, slot] = v[:, 0]
                o = L.attention_scores(q, layer_cache["k"], layer_cache["v"],
                                       positions, kv_pos, causal=False,
                                       window=0, kv_mask=kv_mask)
                y = L.merge_heads(o, p["attn"]["wo"])
        if cfg.uses_ssm:
            sc = {"conv": layer_cache["conv"], "state": layer_cache["state"]}
            ys, sc_new = SSM.mamba_decode_step(p["ssm"], cfg, x, sc)
            layer_cache["conv"].copy_(sc_new["conv"])
            layer_cache["state"].copy_(sc_new["state"])
            y = ys if y is None else y + ys
        return y

    @torch.no_grad()
    def decode_step(self, cache: Params, tokens: torch.Tensor, pos: int,
                    params: Params | None = None):
        """One-token serve step at position ``pos`` (a host int). tokens:
        [B, 1] -> (logits [B, 1, V] f32, cache). The cache is updated in
        place and returned, where the reference returns a new one."""
        cfg = self.cfg
        params = self.params() if params is None else params
        x = L.embed(params["embed"], tokens, cfg.compute_dtype)

        def one_layer(p, x, lc, moe_layer):
            kv_len = (lc["k"].shape[1] if "k" in lc else
                      lc["c_kv"].shape[1] if "c_kv" in lc else 0)
            x = x + self._decode_mixer(p, L.rmsnorm(p["ln1"], x), pos, lc,
                                       kv_len=kv_len)
            if cfg.family != "ssm":
                h2 = L.rmsnorm(p["ln2"], x)
                if moe_layer:
                    y2, _ = MOE.moe_ffn(p["mlp"], cfg, h2)
                else:
                    y2 = L.mlp(p["mlp"], cfg, h2)
                x = x + y2
            return x

        for i, p in enumerate(params.get("dense_blocks", [])):
            lc = {k: v[0] for k, v in cache["dense"][i].items()}
            x = one_layer(p, x, lc, False)
        for i, p in enumerate(params["blocks"]):
            lc = {k: v[i] for k, v in cache["scan"].items()}
            x = one_layer(p, x, lc, cfg.is_moe)
        x = L.rmsnorm(params["ln_f"], x)
        return L.unembed(params["unembed"], x, cfg.logit_softcap), cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, params: Params | None = None, *,
                extra: dict | None = None) -> torch.Tensor:
        """Full-sequence forward returning the last position's logits
        [B, 1, V] (as the reference's, it does not fill a cache)."""
        params = self.params() if params is None else params
        x, _ = self.forward(tokens, params, extra=extra)
        return L.unembed(params["unembed"], x[:, -1:], self.cfg.logit_softcap)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


__all__ = ["Model", "block_forward"]
