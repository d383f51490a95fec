"""Model facade in PyTorch; port of ``src/repro/models/model.py`` for every
family: dense and MoE decoders, MLA, Mamba-only, the parallel attention +
Mamba hybrid, the VLM backbone with its patch prefix, and the whisper
encoder-decoder (LayerNorm blocks, an encoder over stub frame embeddings,
cross-attention, learned positions): init, forward, the chunked next-token
loss, the KV/state caches, the one-token decode step and the fused
prefill.

``Model`` is an ``nn.Module`` whose parameters carry the reference's tree
paths as names (``embed.table``, ``dense_blocks.<i>.mlp.wi``,
``blocks.<i>.attn.wq``, ``blocks.<i>.mlp.shared.wo``, ``ln_f.scale``,
``unembed.w``, ``enc_blocks.<i>.attn.wq``, ``pos_embed``). The reference
stacks the blocks on a leading layer axis and scans over it; the port keeps
one module per layer and loops (``models/convert.py`` moves parameters
between the two layouts). The caches keep the reference's layout
(``{"scan": {name: [L, ...]}, "dense": [{name: [1, ...]}]}``, and whisper's
``cross_k`` / ``cross_v``), and ``decode_step`` writes the new token's
entries into them in place. Remat wraps what the reference's ``_remat``
wraps (each block, each encoder attention half, each cross-entropy chunk)
in ``torch.utils.checkpoint`` (non-reentrant): ``"full"`` recomputes the
whole forward in backward, as ``jax.checkpoint``; ``"dots"`` saves the
outputs of the matrix products and recomputes the rest, as
``jax.checkpoint_policies.checkpoint_dots``. The selective-scan kernels
sit behind an autograd function that calls them through ``ctypes``, which
no dispatch policy sees, so under either policy B7 runs again in backward,
as the reference recomputes its Pallas call.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import ssm as SSM
from ..utils.device import resolve_device
from .config import ModelConfig

Params = dict[str, Any]

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
    norm = L.init_layernorm if cfg.family == "encdec" else L.init_rmsnorm
    p: Params = {"ln1": norm(cfg.d_model, device),
                 "ln2": norm(cfg.d_model, device)}
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
    if cfg.family == "encdec":
        p["ln_cross"] = L.init_layernorm(cfg.d_model, device)
        p["cross"] = L.init_attention(gen, cfg, device)
    return p


def _init_encoder_block(gen: torch.Generator, cfg: ModelConfig,
                        device) -> Params:
    return {"ln1": L.init_layernorm(cfg.d_model, device),
            "ln2": L.init_layernorm(cfg.d_model, device),
            "attn": L.init_attention(gen, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device=device)}


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


def _norm(cfg: ModelConfig):
    return L.layernorm if cfg.family == "encdec" else L.rmsnorm


def _cross_attention(p: Params, cfg: ModelConfig, h: torch.Tensor,
                    positions: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The decoder's attention to the encoder: queries from h [B, S, D]
    (projected as ``qkv_project`` projects them), keys and values k, v
    [B, T, H, Dh] from the encoder output, no causal mask."""
    q = L.project_heads(h, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    b, t = k.shape[:2]
    enc_pos = torch.arange(t, device=k.device).expand(b, t)
    o = L.attention_scores(q, k, v, positions, enc_pos, causal=False)
    return L.merge_heads(o, p["wo"])


def block_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, moe_layer: bool,
                  causal: bool = True, enc_out: torch.Tensor | None = None):
    """Pre-norm residual block. Returns (x, aux_loss). ``enc_out`` [B, T, D]
    (encoder-decoder) adds cross-attention between the mixer and the
    MLP."""
    norm = _norm(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + _mixer(p, cfg, norm(p["ln1"], x), positions, causal=causal)
    if cfg.family == "ssm":
        return x, aux
    if cfg.family == "encdec" and enc_out is not None:
        c = p["cross"]
        x = x + _cross_attention(c, cfg, norm(p["ln_cross"], x), positions,
                                 L.project_heads(enc_out, c["wk"]),
                                 L.project_heads(enc_out, c["wv"]))
    h = norm(p["ln2"], x)
    if moe_layer:
        y, aux = MOE.moe_ffn(p["mlp"], cfg, h)
    else:
        y = L.mlp(p["mlp"], cfg, h)
    return x + y, aux


# the products whose outputs "dots" saves (checkpoint_dots: dot_general)
_DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
         torch.ops.aten.baddbmm)


def _dots_policy(ctx, op, *args, **kwargs):
    if op.overloadpacket in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the config's remat: as it is ("none"), recomputed whole
    in backward ("full"), or with its matrix products' outputs saved and the
    rest recomputed ("dots")."""
    if cfg.remat == "none":
        return fn
    kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


class Model(nn.Module):
    """Port of the reference's ``Model`` for every family.

    It is built on ``device``, the card unless the caller passes
    ``device="cpu"`` (``utils/device.resolve_device``). Parameters are made
    at construction from ``seed`` with a CPU ``torch.Generator`` and then
    moved to ``device``, so a seed gives the same weights on every device
    (the reference draws its own from a ``jax.random`` key; the two give
    different numbers, so tests carry the reference's parameters across
    with ``convert.load_reference_params``). On ``device="meta"`` the
    parameters have their shapes and dtypes and no storage, and no number
    is drawn (the port's ``jax.eval_shape``, for the dry-run).
    """

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator()
        gen.manual_seed(seed)
        if dev.type == "meta":
            # shapes only (the dry-run): every factory call makes a meta
            # tensor, so nothing is allocated and the generator draws nothing
            with torch.device("meta"):
                self._build(cfg, gen, dev)
        else:
            self._build(cfg, gen, dev)

    def _build(self, cfg: ModelConfig, gen: torch.Generator,
               dev: torch.device) -> None:
        self.embed = _Tree(L.init_embedding(gen, cfg.vocab_size,
                                            cfg.d_model, dev))
        n_dense = cfg.first_dense_layers if cfg.is_moe else 0
        self.dense_blocks = nn.ModuleList(
            _Tree(_init_block(gen, cfg, False, dev)) for _ in range(n_dense))
        self.blocks = nn.ModuleList(
            _Tree(_init_block(gen, cfg, cfg.is_moe, dev))
            for _ in range(cfg.n_layers - n_dense))
        encdec = cfg.family == "encdec"
        self.ln_f = _Tree((L.init_layernorm if encdec else L.init_rmsnorm)(
            cfg.d_model, dev))
        self.unembed = _Tree(L.init_unembed(gen, cfg.d_model,
                                            cfg.vocab_size, dev))
        self.enc_blocks = nn.ModuleList(
            _Tree(_init_encoder_block(gen, cfg, dev))
            for _ in range(cfg.n_encoder_layers if encdec else 0))
        if encdec:
            self.enc_ln_f = _Tree(L.init_layernorm(cfg.d_model, dev))
            # learned positions must cover the longest assigned decode
            # context (32k) plus the encoder frames
            self.pos_embed = nn.Parameter((torch.randn(
                (32768 + cfg.n_audio_frames, cfg.d_model), generator=gen,
                dtype=torch.float32) * 0.01).to(dev))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    # ---------------- parameter trees ----------------
    def params(self) -> Params:
        """The parameters as the reference's nested dict, the blocks (and
        the encoder's) as a list (one dict per layer) and ``dense_blocks``
        where there are any."""
        tree: Params = {"embed": self.embed.tree()}
        if len(self.dense_blocks):
            tree["dense_blocks"] = [b.tree() for b in self.dense_blocks]
        tree["blocks"] = [b.tree() for b in self.blocks]
        tree["ln_f"] = self.ln_f.tree()
        tree["unembed"] = self.unembed.tree()
        if self.cfg.family == "encdec":
            tree["enc_blocks"] = [b.tree() for b in self.enc_blocks]
            tree["enc_ln_f"] = self.enc_ln_f.tree()
            tree["pos_embed"] = self.pos_embed
        return tree

    def _encode(self, frames: torch.Tensor, params: Params | None = None):
        """Whisper's encoder over stub frame embeddings [B, T, D] ->
        (encoder output [B, T, D], positions [B, T]). Positions index
        ``pos_embed`` from row 0, as the decoder's do (the reference's).
        Remat wraps each block's attention half only, as the reference's
        ``_encode`` does."""
        cfg = self.cfg
        params = self.params() if params is None else params
        b, t, _ = frames.shape
        pos = torch.arange(t, device=frames.device).expand(b, t)
        x = frames + params["pos_embed"][None, :t].to(frames.dtype)
        attn_half = _remat(lambda p_, x_: x_ + L.attention(
            p_["attn"], cfg, L.layernorm(p_["ln1"], x_), pos, causal=False),
            cfg)
        for p in params["enc_blocks"]:
            x = attn_half(p, x)
            x = x + L.mlp(p["mlp"], cfg, L.layernorm(p["ln2"], x))
        return L.layernorm(params["enc_ln_f"], x), pos

    def cross_kv(self, enc_out: torch.Tensor,
                 params: Params | None = None):
        """Every decoder layer's cross-attention keys and values of an
        encoder output, stacked as ``init_cache``'s ``cross_k`` /
        ``cross_v`` [L, B, T, H, Dh]. Nothing in the reference fills its
        cross-KV cache; its smoke test computes these by hand
        (``tests/test_models_smoke.py``), as callers of the port do with
        this."""
        params = self.params() if params is None else params
        dt = self.cfg.compute_dtype
        enc_out = enc_out.to(dt)
        return (torch.stack([L.project_heads(enc_out, p["cross"]["wk"])
                             for p in params["blocks"]]),
                torch.stack([L.project_heads(enc_out, p["cross"]["wv"])
                             for p in params["blocks"]]))

    # ---------------- forward (training / prefill) ----------------
    def forward(self, tokens: torch.Tensor, params: Params | None = None, *,
                extra: dict | None = None):
        """tokens [B, S_text] -> (hidden [B, S_total, D], aux loss).

        extra: {"patches": [B, n_img, D]} for the VLM, prepended to the
        text embeddings; {"frames": [B, T, D]} for the encoder-decoder,
        run through the encoder, whose output the decoder blocks attend
        to."""
        cfg = self.cfg
        params = self.params() if params is None else params
        dt = cfg.compute_dtype
        x = L.embed(params["embed"], tokens, dt)
        enc_out = None
        if cfg.family == "vlm":
            x = torch.cat([extra["patches"].to(dt), x], dim=1)
        if cfg.family == "encdec":
            enc_out, _ = self._encode(extra["frames"].to(dt), params)
            x = x + params["pos_embed"][None, :x.shape[1]].to(dt)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for moe_layer, stack in ((False, params.get("dense_blocks", [])),
                                 (cfg.is_moe, params["blocks"])):
            fn = _remat(lambda p, x_, moe=moe_layer: block_forward(
                p, cfg, x_, positions, moe_layer=moe, enc_out=enc_out), cfg)
            for p in stack:
                x, aux = fn(p, x)
                aux_total = aux_total + aux
        x = _norm(cfg)(params["ln_f"], x)
        return x, aux_total

    def loss(self, batch: dict, chunk: int = 512,
             params: Params | None = None) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy, computed in sequence chunks so the f32
        logits tensor never exceeds [B, chunk, V]; plus 0.01 x the MoE aux
        loss. The VLM's image positions carry no labels; the batch's
        ``patches`` (VLM) or ``frames`` (encoder-decoder) go to the
        forward."""
        cfg = self.cfg
        params = self.params() if params is None else params
        if cfg.cast_params_bf16:
            dt = cfg.compute_dtype
            params = _map_tree(lambda t: t.to(dt) if t.dtype == torch.float32
                               else t, params)
        x, aux = self.forward(batch["tokens"], params,
                              extra={k: v for k, v in batch.items()
                                     if k in ("patches", "frames")})
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
        layers' conv window and f32 state; the encoder-decoder's
        cross-attention keys and values over ``n_audio_frames``, zeros
        until the caller fills them (``cross_kv``)."""
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
        if cfg.family == "encdec":
            cache["cross_k"] = zeros(n_scan, batch, cfg.n_audio_frames,
                                     cfg.n_heads, cfg.d_head)
            cache["cross_v"] = torch.zeros_like(cache["cross_k"])
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
        place and returned, where the reference returns a new one. The
        encoder-decoder adds ``pos_embed``'s row ``pos`` and attends to the
        cache's cross keys and values."""
        cfg = self.cfg
        params = self.params() if params is None else params
        dt = cfg.compute_dtype
        norm = _norm(cfg)
        x = L.embed(params["embed"], tokens, dt)
        if cfg.family == "encdec":
            x = x + params["pos_embed"][pos][None, None].to(dt)

        def one_layer(p, x, lc, moe_layer, cross=None):
            kv_len = (lc["k"].shape[1] if "k" in lc else
                      lc["c_kv"].shape[1] if "c_kv" in lc else 0)
            x = x + self._decode_mixer(p, norm(p["ln1"], x), pos, lc,
                                       kv_len=kv_len)
            if cross is not None:
                positions = torch.full((x.shape[0], 1), pos,
                                       dtype=torch.int64, device=x.device)
                x = x + _cross_attention(p["cross"], cfg,
                                         norm(p["ln_cross"], x), positions,
                                         *cross)
            if cfg.family != "ssm":
                h2 = norm(p["ln2"], x)
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
            cross = ((cache["cross_k"][i], cache["cross_v"][i])
                     if cfg.family == "encdec" else None)
            x = one_layer(p, x, lc, cfg.is_moe, cross)
        x = norm(params["ln_f"], x)
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
