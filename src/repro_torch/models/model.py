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

Under a ``DeviceMesh`` (parameters placed by
``sharding.rules.distribute_params``, a batch by ``distribute_batch``)
``forward`` and ``loss`` run once a rank (``sharding.spmd``): each rank
takes its rows of the batch, gathers each block's parameters over the data
axes just before the block runs (inside its remat, so backward gathers
them again) and keeps its "model" part of every leaf the rules split
there (``block_params``): the heads of the attention, the
cross-attention (their query heads alone where the rules keep the K/V
projections whole) and MLA, the hidden units of the dense MLP and the shared
expert, the routed experts, the Mamba mixer's channels, and the
vocabulary of the embedding and of the cross-entropy's unembedding, each
a tensor-parallel product. It returns DTensors: the hidden states split
by rows, and the loss as the sum of the ranks' parts (each rank's
cross-entropy over the whole batch's label count, its share of the aux
loss). ``prefill`` and ``decode_step`` serve on a mesh the same way under
any of the reference's three rule sets (``rules=``), whisper included
(``encode`` and ``cross_kv`` give its cross cache in ``cache_specs``'
layout): the cache comes placed by ``cache_specs`` (``init_cache``), the
tokens by ``batch_specs``, and a decode step computes with each
parameter's "model" part (``_decode_params``), each rank writing only its
part of the new token's cache entries; the logits come back split by rows
and whole over the vocabulary.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import ssm as SSM
from ..sharding import spmd as SP
from ..sharding.annotate import DEFAULT_RULES, placements
from ..sharding.rules import cache_specs, distribute_cache
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

def _mixer(p: Params, cfg: ModelConfig, x, positions, *, causal=True,
           split: dict | None = None):
    """Attention and/or SSM sublayer output at full sequence length (the
    hybrid sums the two heads, attention first); ``split`` (``block_params``'
    flags): which of the two runs tensor-parallel over "model"."""
    split = split or {}
    y = None
    if cfg.uses_attention:
        if cfg.attention == "mla":
            y = MLA.mla_attention(p["attn"], cfg, x, positions, causal=causal,
                                  split=split.get("attn", False))
        else:
            y = L.attention(p["attn"], cfg, x, positions, causal=causal,
                            split=split.get("attn", False))
    if cfg.uses_ssm:
        ys = SSM.mamba_forward(p["ssm"], cfg, x,
                               split=split.get("ssm", False))
        y = ys if y is None else y + ys
    return y


def _norm(cfg: ModelConfig):
    return L.layernorm if cfg.family == "encdec" else L.rmsnorm


def _cross_attention(p: Params, cfg: ModelConfig, h: torch.Tensor,
                     positions: torch.Tensor, enc_out: torch.Tensor,
                     split: bool | tuple = False,
                     enc_blocked: tuple = ()) -> torch.Tensor:
    """The decoder's attention to the encoder: queries from h [B, S, D]
    (projected as ``qkv_project`` projects them), keys and values
    [B, T, H, Dh] projected from the encoder output [B, T, D], no causal
    mask. ``split`` (``L.attention``'s): True, ``p`` holds this rank's
    heads (``L.ATTN_SPLIT``); a tuple of the leaves kept whole, this rank's
    query heads and whole ``wk`` / ``wv``, whose columns of the KV heads
    they meet give this rank's K and V (``L.split_queries``). Either way h
    and the encoder output are whole over "model"; each rank's output is
    its part of the sum, added up over the axis. ``enc_blocked``: the
    mesh dims the frames are in blocks over (``SP.seq_axes``): the encoder
    output is this rank's block of them; its keys and values are projected
    there and gathered over those dims, as the reference's partitioned
    program projects them."""
    if isinstance(split, tuple):
        q, k, v = L.split_queries(p, cfg, h, positions, split, enc_out)
    else:
        if split:
            h, enc_out = SP.sum_grads_over_model(h), \
                SP.sum_grads_over_model(enc_out)
        k = L.project_heads(enc_out, p["wk"])
        v = L.project_heads(enc_out, p["wv"])
        q = L.project_heads(h, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"].to(h.dtype)
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    if enc_blocked:
        k, v = (SP.gather_over_axes(t, 1, enc_blocked) for t in (k, v))
    b, t = k.shape[:2]
    enc_pos = torch.arange(t, device=k.device).expand(b, t)
    o = L.attention_scores(q, k, v, positions, enc_pos, causal=False)
    out = L.merge_heads(o, p["wo"])
    return SP.sum_over_model(out) if split else out


def block_params(p: Params, cfg: ModelConfig, moe_layer: bool):
    """A block's parameters for this rank under a mesh (``sharding.spmd``;
    as they are without one): each sublayer split over "model" for
    tensor-parallel products where its layout allows, the heads of the
    attention and the cross-attention (``L.ATTN_SPLIT``; their query heads
    alone where ``L.ATTN_OPTIONAL``'s K/V leaves stay whole) and of MLA
    (``MLA.MLA_SPLIT``, its ``wq_a`` / ``wkv_a`` whole), the dense MLP's
    hidden units (``L.MLP_SPLIT``), the Mamba mixer's channels
    (``SSM.SSM_SPLIT``), a MoE layer's routed experts and shared expert
    (``MOE.moe_parts``); the norms gathered whole. Returns (params,
    {"attn", "cross", "ssm", "mlp" (the dense MLP), "experts", "shared":
    split})."""
    out, split = {}, {"attn": False, "mlp": False}
    for k, v in p.items():
        if k == "attn" and cfg.attention == "mla":
            out[k], split[k] = SP.split_over_model(v, MLA.MLA_SPLIT,
                                                   MLA.MLA_WHOLE)
        elif k in ("attn", "cross"):
            out[k], split[k] = SP.split_over_model(v, L.ATTN_SPLIT,
                                                   optional=L.ATTN_OPTIONAL)
        elif k == "ssm":
            out[k], split[k] = SP.split_over_model(v, SSM.SSM_SPLIT)
        elif k == "mlp" and not moe_layer:
            out[k], split[k] = SP.split_over_model(v, L.MLP_SPLIT)
        elif k == "mlp":
            out[k], flags = MOE.moe_parts(v)
            split.update(flags)
        else:
            out[k] = SP.whole_params(v)
    return out, split


def block_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, moe_layer: bool,
                  causal: bool = True, enc_out: torch.Tensor | None = None,
                  split: dict | None = None, enc_blocked: tuple = ()):
    """Pre-norm residual block. Returns (x, aux_loss). ``enc_out`` [B, T, D]
    (encoder-decoder) adds cross-attention between the mixer and the
    MLP (``enc_blocked``: the mesh dims of the frames' blocks,
    ``_cross_attention``'s). ``split`` (``block_params``' second value)
    says which sublayers hold this rank's part of a tensor-parallel
    product."""
    split = split or {}
    norm = _norm(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + _mixer(p, cfg, norm(p["ln1"], x), positions, causal=causal,
                   split=split)
    if cfg.family == "ssm":
        return x, aux
    if cfg.family == "encdec" and enc_out is not None:
        x = x + _cross_attention(p["cross"], cfg, norm(p["ln_cross"], x),
                                 positions, enc_out,
                                 split=split.get("cross", False),
                                 enc_blocked=enc_blocked)
    h = norm(p["ln2"], x)
    if moe_layer:
        y, aux = MOE.moe_ffn(p["mlp"], cfg, h,
                             shared_split=split.get("shared", False),
                             experts_split=split.get("experts", False))
    else:
        y = L.mlp(p["mlp"], cfg, h, split=split.get("mlp", False))
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
    rest recomputed ("dots"). A recomputation runs in its forward's mesh
    context (``sharding.spmd``)."""
    if cfg.remat == "none":
        return fn
    kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def wrapped(*args):
        ctx = SP.current()

        def run(*a):
            with SP.within(ctx):
                return fn(*a)
        return checkpoint(run, *args, use_reentrant=False, **kw)
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

    def _mesh(self):
        table = self.embed.table
        return table.device_mesh if isinstance(table, DTensor) else None

    def _encode(self, frames: torch.Tensor, params: Params | None = None,
                blocked: tuple = ()):
        """Whisper's encoder over stub frame embeddings [B, T, D] ->
        (encoder output [B, T, D], positions [B, T]). Positions index
        ``pos_embed`` from row 0, as the decoder's do (the reference's).
        Remat wraps each block's attention half only, as the reference's
        ``_encode`` does. ``blocked``: the mesh dims ``frames`` is in
        blocks over (``sharding.spmd.seq_axes``): it is this rank's block of
        the frames, whose positions, rows of ``pos_embed`` and output are
        the block's; its attention attends over the keys and values
        gathered over those dims."""
        cfg = self.cfg
        params = self.params() if params is None else params
        b, t, _ = frames.shape
        whole = SP.whole_params
        with SP.sequence(t * SP.ways(blocked), blocked):
            pos = SP.seq_positions(b, t, frames.device)
            start = SP.seq_block()[0] if blocked else 0
            x = frames + whole(params["pos_embed"])[None, start:start + t].to(
                frames.dtype)

            def attn(p_, x_):
                a, split = SP.split_over_model(p_["attn"], L.ATTN_SPLIT,
                                               optional=L.ATTN_OPTIONAL)
                return x_ + L.attention(a, cfg,
                                        L.layernorm(whole(p_["ln1"]), x_),
                                        pos, causal=False, split=split)

            attn_half = _remat(attn, cfg)
            for p in params["enc_blocks"]:
                x = attn_half({"attn": p["attn"], "ln1": p["ln1"]}, x)
                m, split = SP.split_over_model(p["mlp"], L.MLP_SPLIT)
                x = x + L.mlp(m, cfg, L.layernorm(whole(p["ln2"]), x),
                              split=split)
        return L.layernorm(whole(params["enc_ln_f"]), x), pos

    def cross_kv(self, enc_out: torch.Tensor,
                 params: Params | None = None, *, rules=DEFAULT_RULES):
        """Every decoder layer's cross-attention keys and values of an
        encoder output, stacked as ``init_cache``'s ``cross_k`` /
        ``cross_v`` [L, B, T, H, Dh]. Nothing in the reference fills its
        cross-KV cache; its smoke test computes these by hand
        (``tests/test_models_smoke.py``), as callers of the port do with
        this.

        On a meshed model ``enc_out`` is ``encode``'s DTensor (rows placed
        by ``batch_specs(rules)``) and the two come back as DTensors in the
        layout ``cache_specs(rules)`` gives them, each rank computing only
        its shard: its heads from ``wk`` / ``wv``'s "model" part (heads on
        "model"), its run of the frames (``SERVING_RULES``' "seq_kv") or of
        each head's columns (the head-dim fallback), under no gradient."""
        params = self.params() if params is None else params
        dt = self.cfg.compute_dtype
        mesh = self._mesh()
        if mesh is None:
            enc_out = enc_out.to(dt)
            return (torch.stack([L.project_heads(enc_out, p["cross"]["wk"])
                                 for p in params["blocks"]]),
                    torch.stack([L.project_heads(enc_out, p["cross"]["wv"])
                                 for p in params["blocks"]]))
        rows = self._placed(enc_out, "encoder outputs").shape[0]
        b, t, _ = enc_out.shape
        cfg = self.cfg
        shape = (len(params["blocks"]), b, t, cfg.n_heads, cfg.d_head)
        spec = cache_specs({"cross_k": torch.empty(shape, device="meta")},
                           mesh, rules)["cross_k"]
        layout = placements(spec, mesh)
        with torch.no_grad(), SP.spmd(mesh, rows, rules):
            enc = SP.whole_batch(enc_out).to(dt)
            m = mesh.mesh_dim_names.index("model")
            cache_dim = (layout[m].dim - 1 if isinstance(layout[m], Shard)
                         and mesh.size(m) > 1 else None)
            if cache_dim == 1:          # this rank's frames
                enc = SP.model_slice(enc, 1)

            def project(w):
                w, dim = SP.model_part(w)
                y = L.project_heads(enc, w)
                if dim is not None and cache_dim != 2:
                    y = SP.gather_over_model(y, 2)
                elif dim is None and cache_dim == 2:
                    y = SP.model_slice(y, 2)
                return SP.model_slice(y, -1) if cache_dim == 3 else y

            out = []
            for name in ("wk", "wv"):
                local = torch.stack([project(p["cross"][name])
                                     for p in params["blocks"]])
                out.append(DTensor.from_local(
                    local.contiguous(), mesh, layout, run_check=False,
                    shape=torch.Size(shape),
                    stride=torch.empty(shape, device="meta").stride()))
            return tuple(out)

    # ---------------- forward (training / prefill) ----------------
    def forward(self, tokens: torch.Tensor, params: Params | None = None, *,
                extra: dict | None = None):
        """tokens [B, S_text] -> (hidden [B, S_total, D], aux loss); under
        a mesh the hidden states as a DTensor split by rows and the aux
        loss as the sum of the ranks' parts (see ``_forward``)."""
        mesh = self._mesh()
        if mesh is None or SP.current() is not None:
            return self._forward(tokens, params, extra=extra)
        with SP.spmd(mesh, tokens.shape[0]):
            x, aux = self._forward(
                SP.whole_batch(tokens), params,
                extra={k: SP.whole_batch(v) for k, v in (extra or {}).items()})
            return (SP.as_batch_rows(x),
                    SP.as_batch_partial(aux / SP.batch_shards()))

    def _forward(self, tokens: torch.Tensor, params: Params | None = None, *,
                 extra: dict | None = None, blocked: dict | None = None,
                 last: bool = False):
        """tokens [B, S_text] -> (hidden [B, S_total, D], aux loss).

        extra: {"patches": [B, n_img, D]} for the VLM, prepended to the
        text embeddings; {"frames": [B, T, D]} for the encoder-decoder,
        run through the encoder, whose output the decoder blocks attend
        to.

        ``blocked`` ({leaf: ``sharding.spmd.seq_axes``}, a prefill under a
        mesh): the leaves it marks hold this rank's block of their sequence
        over those mesh dims. Where the decoder's sequence is in blocks (the
        tokens'), each rank runs its block on its own positions, every
        position-wise product on it only, and exchanges only what crosses
        blocks (``sharding.spmd.sequence``: the attention's keys and values,
        the Mamba conv window and scan state, a MoE group's counts). The
        VLM's sequence, patches followed by the text, is in blocks over the
        tokens' dims where they divide it: each rank receives the patch
        rows and the token ids of its block from the ranks that hold them
        (``SP.seq_exchange``, an all-to-all) and embeds its own tokens only.
        Frames in blocks run the encoder so, and the cross-attention's keys
        and values are projected from each rank's block of its output and
        gathered. ``last``: (the last position's row [B, 1, D], on every
        rank, aux loss)."""
        cfg = self.cfg
        params = self.params() if params is None else params
        blocked = blocked or {}
        dt = cfg.compute_dtype
        whole = SP.whole_params
        enc_out, enc_blocked = None, blocked.get("frames", ())
        if cfg.family == "encdec":
            enc_out, _ = self._encode(extra["frames"].to(dt), params,
                                      blocked=enc_blocked)
        split = blocked.get("tokens", ())
        if cfg.family == "vlm":
            patches = extra["patches"].to(dt)
            n_img = patches.shape[1] * SP.ways(blocked.get("patches", ()))
            total = n_img + tokens.shape[1] * SP.ways(split)
            if total % SP.ways(split):
                # no block of the concatenation: every rank takes it whole
                split = ()
        else:
            # this rank's run of a vocabulary split over "model", summed
            # there
            x = L.embed_part(*SP.model_part(params["embed"]["table"]),
                             tokens, dt)
            total = x.shape[1] * SP.ways(split)
        with SP.sequence(total, split):
            if cfg.family == "vlm":
                x = self._vlm_embed(params, tokens, patches, n_img, blocked)
            b, s, _ = x.shape
            positions = SP.seq_positions(b, s, x.device)
            if cfg.family == "encdec":
                start = SP.seq_block()[0] if split else 0
                x = x + whole(params["pos_embed"])[None, start:start + s].to(
                    dt)
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
            for moe_layer, stack in ((False, params.get("dense_blocks", [])),
                                     (cfg.is_moe, params["blocks"])):
                def run(p, x_, moe=moe_layer):
                    p, split_ = block_params(p, cfg, moe)
                    return block_forward(p, cfg, x_, positions, moe_layer=moe,
                                         enc_out=enc_out, split=split_,
                                         enc_blocked=enc_blocked)

                fn = _remat(run, cfg)
                for p in stack:
                    x, aux = fn(p, x)
                    aux_total = aux_total + aux
            x = _norm(cfg)(whole(params["ln_f"]), x)
            if last:
                x = SP.seq_last(x[:, -1:].contiguous())
        return x, aux_total

    def _vlm_embed(self, params: Params, tokens, patches, n_img: int,
                   blocked: dict) -> torch.Tensor:
        """The VLM's input rows, the ``n_img`` patches followed by the text
        embeddings: this rank's block of them where the sequence is in
        blocks (``sharding.spmd.seq_block``), its patch rows and token ids
        received from the ranks that hold them (``SP.seq_exchange``: each
        leaf in blocks over the mesh dims ``blocked`` names, or whole) and
        only its own tokens embedded; all of them otherwise (each leaf
        gathered whole)."""
        dt = self.cfg.compute_dtype
        if SP.seq_block() is None:
            patches = SP.gather_over_axes(patches, 1,
                                          blocked.get("patches", ()))
            tokens = SP.gather_over_axes(tokens, 1,
                                         blocked.get("tokens", ()))
        else:
            patches = SP.seq_exchange(patches, blocked.get("patches", ()), 0)
            tokens = SP.seq_exchange(tokens, blocked.get("tokens", ()),
                                     n_img)
        parts = [patches]
        if tokens.shape[1]:
            parts.append(L.embed_part(
                *SP.model_part(params["embed"]["table"]), tokens, dt))
        return torch.cat(parts, dim=1)

    def loss(self, batch: dict, chunk: int = 512,
             params: Params | None = None) -> tuple[torch.Tensor, dict]:
        """The loss of ``_loss``; under a mesh each rank computes its part
        on its rows, and the loss, ``ce`` and ``aux`` come back as DTensors
        of the sum of the parts (``sharding.spmd.full_value`` gives the
        value; the gradient of a rank's part, ``to_local``, is that
        rank's)."""
        mesh = self._mesh()
        if mesh is None:
            return self._loss(batch, chunk, params)
        with SP.spmd(mesh, batch["tokens"].shape[0]):
            total, m = self._loss({k: SP.whole_batch(v)
                                   for k, v in batch.items()}, chunk, params)
            return SP.as_batch_partial(total), {
                "ce": SP.as_batch_partial(m["ce"]),
                "aux": SP.as_batch_partial(m["aux"]), "tokens": m["tokens"]}

    def _loss(self, batch: dict, chunk: int = 512,
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
        aux = aux / SP.batch_shards()       # a rank's part of the mean
        total = ce + 0.01 * aux
        return total, {"ce": ce, "aux": aux, "tokens": n_valid}

    def ce_loss(self, x: torch.Tensor, labels: torch.Tensor, params: Params,
                chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
        """Mean next-token cross-entropy of hidden states x [B, S, D] over
        the labels >= 0, one sequence chunk of logits at a time; returns
        (ce, number of valid labels).

        Under a mesh whose "model" axis splits the vocabulary (the rules'
        "vocab": wherever the axis divides it), the unembedding is
        vocabulary-parallel: each rank takes its columns of ``unembed.w``
        (gathered over the data axes only) and computes its ``[B, chunk,
        V / tp]`` logits, softcap included; the log-sum-exp shifts by the
        max over "model" and sums the exponentials over "model", and the
        gold logit comes from the rank whose run holds the label, summed
        over "model". Each rank's gradient is its slice of ``softmax -
        one_hot``, the input's summed over "model". A vocabulary the axis
        does not divide (whisper's 51865, hymba's 32001) stays whole, as
        the resolver leaves it."""
        cfg = self.cfg
        b, s, d = x.shape
        chunk = min(chunk, s)
        pad = (-s) % chunk
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
        w, vocab_split = SP.split_over_model({"w": params["unembed"]["w"]},
                                             {"w": 1})
        unembed_c = {"w": w["w"].to(cfg.compute_dtype)}

        def ce_chunk(xi, li):
            valid = li >= 0
            if vocab_split:
                ce = _vocab_parallel_ce(unembed_c, cfg, xi, li)
            else:
                logits = L.unembed(unembed_c, xi, cfg.logit_softcap)
                logz = torch.logsumexp(logits, dim=-1)
                idx = torch.clamp_min(li, 0).long()[..., None]
                gold = torch.gather(logits, -1, idx)[..., 0]
                ce = logz - gold
            ce = torch.where(valid, ce, 0.0)
            return ce.sum(), valid.sum()

        fn = _remat(ce_chunk, cfg)
        ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        n_valid = torch.zeros((), dtype=torch.int64, device=x.device)
        for c0 in range(0, x.shape[1], chunk):
            ce_c, nv = fn(x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
            ce_sum = ce_sum + ce_c
            n_valid = n_valid + nv
        # under a mesh: this rank's rows over the whole batch's count
        n_valid = SP.batch_sum(n_valid)
        return ce_sum / torch.clamp_min(n_valid, 1), n_valid

    # ---------------- serving ----------------
    def init_cache(self, batch: int, max_len: int, *,
                   rules=DEFAULT_RULES) -> Params:
        """Per-layer caches sized for the serving context, stacked as the
        reference stacks them: attention keys and values (MLA: the latent
        and the rope key) of ``min(window, max_len)`` slots when the
        attention is windowed (a ring buffer), else ``max_len``; the SSM
        layers' conv window and f32 state; the encoder-decoder's
        cross-attention keys and values over ``n_audio_frames``, zeros
        until the caller fills them (``cross_kv``).

        On a meshed model (parameters placed by ``distribute_params``) the
        leaves are DTensors on its mesh, placed by ``cache_specs(rules)``
        (``sharding.rules.distribute_cache``), each rank's shard made as
        zeros of its local shape."""
        mesh = self._mesh()
        if mesh is None:
            return self._cache_tree(batch, max_len, self.device)
        return distribute_cache(self._cache_tree(batch, max_len, "meta"),
                                mesh, rules)

    def _cache_tree(self, batch: int, max_len: int, dev) -> Params:
        cfg = self.cfg
        dt = cfg.compute_dtype
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
                      layer_cache: Params, *, kv_len: int,
                      dims: dict | None = None,
                      cache_dims: dict | None = None) -> torch.Tensor:
        """One-token mixer step against one layer's cache, which it updates
        in place. x: [B, 1, D]. Under a mesh ``dims`` holds the "model"
        dims of the sublayers' parameter parts ({"attn": {...}, "ssm":
        {...}}), ``cache_dims`` each cache leaf's layer-local dim split over
        "model", and ``kv_len`` is the whole cache's slot count."""
        cfg = self.cfg
        dims, cache_dims = dims or {}, cache_dims or {}
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
                y = MLA.mla_decode(p["attn"], cfg, x, positions,
                                   layer_cache["c_kv"],
                                   layer_cache["k_rope"], slot, kv_pos,
                                   kv_mask, cache_dim=cache_dims.get("c_kv"),
                                   dims=dims.get("attn"))
            else:
                y = L.decode_attention(p["attn"], cfg, x, positions,
                                       layer_cache["k"], layer_cache["v"],
                                       slot, kv_mask, dims=dims.get("attn"),
                                       cache_dim=cache_dims.get("k"))
        if cfg.uses_ssm:
            sc = {"conv": layer_cache["conv"], "state": layer_cache["state"]}
            ys, sc_new = SSM.mamba_decode_step(p["ssm"], cfg, x, sc,
                                               dims=dims.get("ssm"))
            layer_cache["conv"].copy_(sc_new["conv"])
            layer_cache["state"].copy_(sc_new["state"])
            y = ys if y is None else y + ys
        return y

    def _decode_params(self, p: Params, moe_layer: bool, tokens: int):
        """A block's parameters for one decode step of a rank's ``tokens``
        tokens: as they are on one device; under a mesh the "model" parts
        (``SP.model_parts``) of the attention's, MLA's, the
        cross-attention's and the Mamba mixer's leaves, the dense MLP's
        tensor-parallel split (``SP.decode_split``), a MoE layer's routed
        experts and shared expert (``MOE.moe_parts``), the norms whole: no
        leaf the rules split over "model" is gathered there. Where the rows
        are whole on the data axes (``LONG_CONTEXT_RULES``) each leaf also
        keeps its data shard of ``d_model`` (``SP.decode_part``), which the
        products contract or give their output columns from: no leaf is
        gathered at all. So do a MoE layer's leaves where the layer gathers
        its rows over the data axes (``MOE.gathers_rows``). Returns
        (params, "model" dims of the parts, {"mlp", "experts", "shared":
        split})."""
        out, dims, split = {}, {}, {}
        for k, v in p.items():
            if k in ("ssm", "attn", "cross"):
                out[k], dims[k] = SP.model_parts(v)
            elif k == "mlp" and not moe_layer:
                out[k], split["mlp"] = SP.decode_split(v, L.MLP_SPLIT)
            elif k == "mlp":
                out[k], flags = MOE.moe_parts(
                    v, decode=True,
                    gathered=MOE.gathers_rows(self.cfg, tokens))
                split.update(flags)
            else:
                out[k] = SP.whole_params(v)
        return out, dims, split

    @staticmethod
    def _stack_cache(stack: Params, rows: int):
        """A stacked cache ({name: [L, B, ...]}) as local tensors (each
        rank's shard of a DTensor, written in place), each leaf's
        layer-local dim split over "model" (None: whole there) and the
        whole cache's slot count."""
        local, dims, kv_len = {}, {}, 0
        for k, v in stack.items():
            d = SP.model_dim(v)
            dims[k] = None if d is None else d - 1
            local[k] = v.to_local() if isinstance(v, DTensor) else v
            if local[k].shape[1] != rows:
                raise ValueError(f"cache leaf {k} holds {local[k].shape[1]} "
                                 f"rows where the tokens hold {rows}: place "
                                 f"both by the same rules")
            if k in ("k", "c_kv"):
                kv_len = v.shape[2]
        return local, dims, kv_len

    def _decode(self, cache: Params, tokens: torch.Tensor, pos: int,
                params: Params | None = None):
        """The decode step on this rank's rows: (logits [B, 1, V] f32, or
        under a mesh this rank's run of the vocabulary where the
        unembedding is split over "model"; whether it is)."""
        cfg = self.cfg
        params = self.params() if params is None else params
        dt = cfg.compute_dtype
        norm = _norm(cfg)
        whole = SP.whole_params
        # a table or a row that holds this rank's data shard of d_model
        # gives its columns, gathered (SP.decode_part)
        x = SP.data_whole(L.embed_part(
            *SP.decode_part(params["embed"]["table"]), tokens, dt),
            cfg.d_model)
        if cfg.family == "encdec":
            x = x + SP.data_whole(SP.decode_part(params["pos_embed"])[0][
                pos][None, None], cfg.d_model).to(dt)

        def one_layer(p, x, lc, kv_len, cache_dims, moe_layer, cross=None):
            p, dims, split = self._decode_params(p, moe_layer,
                                                 x.shape[0] * x.shape[1])
            x = x + self._decode_mixer(p, norm(p["ln1"], x), pos, lc,
                                       kv_len=kv_len, dims=dims,
                                       cache_dims=cache_dims)
            if cross is not None:
                positions = torch.full((x.shape[0], 1), pos,
                                       dtype=torch.int64, device=x.device)
                x = x + L.cross_decode_attention(
                    p["cross"], cfg, norm(p["ln_cross"], x), positions,
                    *cross, dims=dims.get("cross"),
                    cache_dim=cross_dims.get("cross_k"))
            if cfg.family != "ssm":
                h2 = norm(p["ln2"], x)
                if moe_layer:
                    y2, _ = MOE.moe_ffn(
                        p["mlp"], cfg, h2, split.get("shared", False),
                        split.get("experts", False))
                else:
                    y2 = L.mlp(p["mlp"], cfg, h2,
                               split=split.get("mlp", False))
                x = x + y2
            return x

        rows = tokens.shape[0]
        cross_dims = {}
        if cfg.family == "encdec":
            cross_local, cross_dims, _ = self._stack_cache(
                {k: cache[k] for k in ("cross_k", "cross_v")}, rows)
        for i, p in enumerate(params.get("dense_blocks", [])):
            lc, cache_dims, kv_len = self._stack_cache(cache["dense"][i], rows)
            x = one_layer(p, x, {k: v[0] for k, v in lc.items()}, kv_len,
                          cache_dims, False)
        lc, cache_dims, kv_len = self._stack_cache(cache["scan"], rows)
        for i, p in enumerate(params["blocks"]):
            cross = ((cross_local["cross_k"][i], cross_local["cross_v"][i])
                     if cfg.family == "encdec" else None)
            x = one_layer(p, x, {k: v[i] for k, v in lc.items()}, kv_len,
                          cache_dims, cfg.is_moe, cross)
        x = norm(whole(params["ln_f"]), x)
        w, vdim = SP.decode_part(params["unembed"]["w"])
        return L.unembed({"w": w}, x, cfg.logit_softcap), vdim is not None

    @staticmethod
    def _placed(tokens, what: str = "tokens"):
        if not isinstance(tokens, DTensor):
            raise TypeError(f"under a mesh the {what} are a DTensor placed "
                            "by batch_specs (sharding.rules.distribute_batch)")
        return tokens

    @torch.no_grad()
    def encode(self, frames: torch.Tensor, params: Params | None = None, *,
               rules=DEFAULT_RULES) -> torch.Tensor:
        """Whisper's encoder output [B, T, D] of stub frame embeddings
        [B, T, D] (serving: no gradient), in the compute dtype; what
        ``cross_kv`` projects. On a meshed model the encoder runs once a
        rank on frames placed by ``batch_specs(rules)``, its attention and
        MLP tensor-parallel over "model", and the output comes back as a
        DTensor split as the frames are: by rows, or, where they hold a block
        of the frames a rank (``LONG_CONTEXT_RULES``), by that block, each
        rank running the encoder on its block (``_encode``'s ``blocked``)."""
        dt = self.cfg.compute_dtype
        mesh = self._mesh()
        if mesh is None:
            return self._encode(frames.to(dt), params)[0]
        with SP.spmd(mesh, self._placed(frames, "frames").shape[0], rules):
            blocked = SP.seq_axes(frames)
            enc, _ = self._encode(SP.local_batch(frames).to(dt), params,
                                  blocked=blocked)
            if not blocked:
                return SP.as_batch_rows(enc)
            return DTensor.from_local(enc, mesh, frames.placements,
                                      run_check=False, shape=frames.shape,
                                      stride=frames.stride())

    @torch.no_grad()
    def decode_step(self, cache: Params, tokens: torch.Tensor, pos: int,
                    params: Params | None = None, *, rules=DEFAULT_RULES):
        """One-token serve step at position ``pos`` (a host int). tokens:
        [B, 1] -> (logits [B, 1, V] f32, cache). The cache is updated in
        place and returned, where the reference returns a new one. The
        encoder-decoder adds ``pos_embed``'s row ``pos`` and attends to the
        cache's cross keys and values.

        On a meshed model the step runs once a rank (``sharding.spmd``) on
        tokens placed by ``batch_specs(rules)`` (a DTensor) and a cache
        placed by ``cache_specs(rules)`` (``init_cache(..., rules=rules)``):
        each rank takes its rows (all of them under ``LONG_CONTEXT_RULES``,
        whose batch is whole on every rank), each block takes its
        parameters' "model" parts or gathers the leaves its layout needs
        whole (``_decode_params``), and each rank writes its own part of
        the new token's cache entries. Where the rows are whole on the data
        axes, each leaf keeps its data shard of ``d_model`` as well: the
        embedding's and every output projection's columns are gathered,
        every product that contracts ``d_model`` (the unembedding's too)
        is summed over the data axes, and no parameter is gathered. The
        logits come back as a DTensor [B, 1, V] split by rows as the tokens
        are and whole over the vocabulary (the ranks' runs of a vocabulary
        split over "model" gathered); ``launch.serve.generate`` takes the
        greedy token from the runs instead (``SP.argmax_over_model``)."""
        mesh = self._mesh()
        if mesh is None:
            return self._decode(cache, tokens, pos, params)[0], cache
        with SP.spmd(mesh, self._placed(tokens).shape[0], rules):
            logits, split = self._decode(cache, SP.local_batch(tokens), pos,
                                         params)
            if split:
                logits = SP.gather_over_model(logits, -1)
            return SP.as_batch_rows(logits), cache

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, params: Params | None = None, *,
                extra: dict | None = None, rules=DEFAULT_RULES
                ) -> torch.Tensor:
        """Full-sequence forward returning the last position's logits
        [B, 1, V] (as the reference's, it does not fill a cache).

        On a meshed model the forward runs once a rank (``sharding.spmd``)
        on tokens (and ``extra``) placed by ``batch_specs(rules)``: each
        rank takes its rows, and the logits come back as ``decode_step``'s
        do, a DTensor split by rows and whole over the vocabulary. Under
        ``LONG_CONTEXT_RULES`` every rank holds the whole batch and, where
        the sequence divides the data axes, its block of the sequence
        (``_forward``'s ``blocked``): the blocks run as the reference's
        partitioned program keeps them, the last position's row, which the
        last data rank computes, is gathered onto every rank, and each rank
        unembeds it (the reference's program moves that row by a
        collective-permute)."""
        mesh = self._mesh()
        params = self.params() if params is None else params
        if mesh is None:
            x, _ = self.forward(tokens, params, extra=extra)
            # contiguous: a strided operand's product takes another path
            # when the weight needs no gradient (the meshed one below)
            return L.unembed(params["unembed"], x[:, -1:].contiguous(),
                             self.cfg.logit_softcap)
        with SP.spmd(mesh, self._placed(tokens).shape[0], rules):
            batch = {"tokens": tokens, **(extra or {})}
            x, _ = self._forward(
                SP.local_batch(tokens), params,
                extra={k: SP.local_batch(v) for k, v in (extra or {}).items()},
                blocked={k: SP.seq_axes(v) for k, v in batch.items()},
                last=True)
            w, vdim = SP.model_part(params["unembed"]["w"])
            logits = L.unembed({"w": w}, x, self.cfg.logit_softcap)
            if vdim is not None:
                logits = SP.gather_over_model(logits, -1)
            return SP.as_batch_rows(logits)


def _vocab_parallel_ce(p: Params, cfg: ModelConfig, x: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Each position's ``logsumexp(logits) - logits[label]`` from this
    model rank's run of the vocabulary (``p["w"]``, [D, V / tp]); x is
    whole over "model" (``Model.ce_loss``)."""
    x = SP.sum_grads_over_model(x)
    logits = L.unembed(p, x, cfg.logit_softcap)               # [B, c, V/tp]
    n = logits.shape[-1]
    top = SP.max_over_model(logits.amax(dim=-1))
    logz = top + torch.log(SP.sum_over_model(
        torch.exp(logits - top[..., None]).sum(dim=-1)))
    local = labels.long() - SP.model_axis()[1] * n
    inside = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.clamp(local, 0, n - 1)[..., None])
    gold = SP.sum_over_model(torch.where(inside, gold[..., 0], 0.0))
    return logz - gold


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


__all__ = ["Model", "block_forward"]
