"""Model facade in PyTorch; port of ``src/repro/models/model.py`` for the
SSM family (Mamba-only blocks): init, forward and the chunked next-token
loss.

``Model`` is an ``nn.Module`` whose parameters carry the reference's tree
paths as names (``embed.table``, ``blocks.<i>.ssm.in_proj``, ``ln_f.scale``,
``unembed.w``). The reference stacks the blocks on a leading layer axis and
scans over it; the port keeps one module per layer and loops
(``models/convert.py`` moves parameters between the two layouts).
``remat="full"`` wraps each block and each cross-entropy chunk in
``torch.utils.checkpoint`` (non-reentrant), where the reference used
``jax.checkpoint``.

Other families (attention, MoE, MLA, encoder-decoder, VLM) and
``remat="dots"`` wait for a later slice (ROADMAP Queue A 14) and raise.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import ssm as SSM
from ..utils.device import resolve_device
from .config import ModelConfig

Params = dict[str, Any]

_LATER = "ROADMAP Queue A 14 (the rest of the training stack)"


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"repro_torch models implement the 'ssm' family only; "
            f"{cfg.name} is '{cfg.family}': {_LATER}")
    if cfg.remat not in ("none", "full"):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported (only 'none' and 'full'): "
            f"{_LATER}")


def _params_dict(tree: Params) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


class _Block(nn.Module):
    """One Mamba-only block: pre-norm residual around the SSM mixer (a
    single norm, as the reference's ``_init_block`` leaves it)."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = _params_dict(L.init_rmsnorm(cfg.d_model, device))
        self.ssm = _params_dict(SSM.init_mamba(gen, cfg, device))


def block_forward(p: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    """Pre-norm residual SSM block (the reference returns an aux loss of 0
    beside it for this family)."""
    return x + SSM.mamba_forward(p["ssm"], cfg, L.rmsnorm(p["ln1"], x))


def _remat(fn, cfg: ModelConfig):
    if cfg.remat == "none":
        return fn

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


class Model(nn.Module):
    """Port of the reference's ``Model`` for ``cfg.family == "ssm"``.

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
        self.embed = _params_dict(L.init_embedding(gen, cfg.vocab_size,
                                                   cfg.d_model, dev))
        self.blocks = nn.ModuleList(_Block(gen, cfg, dev)
                                    for _ in range(cfg.n_layers))
        self.ln_f = _params_dict(L.init_rmsnorm(cfg.d_model, dev))
        self.unembed = _params_dict(L.init_unembed(gen, cfg.d_model,
                                                   cfg.vocab_size, dev))

    # ---------------- parameter trees ----------------
    def params(self) -> Params:
        """The parameters as the reference's nested dict, blocks as a list
        (one dict per layer)."""
        return {"embed": dict(self.embed),
                "blocks": [{"ln1": dict(b.ln1), "ssm": dict(b.ssm)}
                           for b in self.blocks],
                "ln_f": dict(self.ln_f),
                "unembed": dict(self.unembed)}

    # ---------------- forward (training / prefill) ----------------
    def forward(self, tokens: torch.Tensor, params: Params | None = None):
        """tokens [B, S] -> (hidden [B, S, D], aux loss)."""
        cfg = self.cfg
        params = self.params() if params is None else params
        x = L.embed(params["embed"], tokens, cfg.compute_dtype)
        fn = _remat(lambda p, x_: block_forward(p, cfg, x_), cfg)
        for p in params["blocks"]:
            x = fn(p, x)
        x = L.rmsnorm(params["ln_f"], x)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, batch: dict, chunk: int = 512,
             params: Params | None = None) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy, computed in sequence chunks so the f32
        logits tensor never exceeds [B, chunk, V]."""
        cfg = self.cfg
        params = self.params() if params is None else params
        if cfg.cast_params_bf16:
            dt = cfg.compute_dtype
            params = _map_tree(lambda t: t.to(dt) if t.dtype == torch.float32
                               else t, params)
        x, aux = self.forward(batch["tokens"], params)
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


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


__all__ = ["Model", "block_forward"]
