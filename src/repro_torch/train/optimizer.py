"""Optimizers as plain functions on tensors; port of
``src/repro/train/optimizer.py``.

The reference maps its formulas over parameter pytrees; here a "tree" is a
flat dict {name: tensor} (the port's ``Model.named_parameters()``), and each
formula is the reference's, in its order. ``torch.optim`` is not used: its
AdamW applies weight decay before the moment update, not inside the step
as the reference does.

AdamW is the default; Adafactor (factored second moments) keeps m+n floats
for an [m, n] matrix instead of 2mn. Its factoring follows each leaf's rank,
so on the port's per-layer parameters it factors what the reference's
stacked [L, ...] parameters factor per layer, but a 1-D per-layer parameter
is a 2-D stacked one there (ROADMAP Queue C).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32 (a 0-d tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * torch.minimum(warm, decay)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: dict) -> dict:
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()}}


def global_norm(tree: dict) -> torch.Tensor:
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def _step_tensor(step, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step, device=like.device).to(torch.float32)


def adamw_update(cfg: OptConfig, params: dict, grads: dict, opt_state: dict,
                 step):
    """Returns (new params, new state, {"lr", "grad_norm"}); pure."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    like = next(iter(params.values()))
    lr = lr_schedule(cfg, _step_tensor(step, like))
    t = _step_tensor(step, like) + 1.0
    bc1 = 1.0 - cfg.beta1 ** t
    bc2 = 1.0 - cfg.beta2 ** t
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        m2 = cfg.beta1 * opt_state["m"][k] + (1 - cfg.beta1) * g32
        v2 = cfg.beta2 * opt_state["v"][k] + (1 - cfg.beta2) * torch.square(g32)
        mh = m2 / bc1
        vh = v2 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p
        new_p[k] = (p - lr * delta).to(p.dtype)
        new_m[k], new_v[k] = m2, v2
    return new_p, {"m": new_m, "v": new_v}, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------

def adafactor_init(params: dict) -> dict:
    def one(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros_like(p, dtype=torch.float32)}
    return {"f": {k: one(p) for k, p in params.items()}}


def adafactor_update(cfg: OptConfig, params: dict, grads: dict,
                     opt_state: dict, step, decay: float = 0.8):
    """Returns (new params, new state, {"lr", "grad_norm"}); pure."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    like = next(iter(params.values()))
    lr = lr_schedule(cfg, _step_tensor(step, like))
    t = _step_tensor(step, like) + 1.0
    beta2 = 1.0 - t ** (-decay)
    new_p, new_f = {}, {}
    for k, p in params.items():
        s = opt_state["f"][k]
        g32 = grads[k].to(torch.float32)
        g2 = torch.square(g32) + 1e-30
        if p.dim() >= 2:
            vr = beta2 * s["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * s["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True),
                                    1e-30)
            v = (vr[..., None] * vc[..., None, :]) / denom[..., None]
            new_f[k] = {"vr": vr, "vc": vc}
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            new_f[k] = {"v": v}
        update = g32 * torch.rsqrt(v + 1e-30)
        # update clipping (Adafactor's RMS trick)
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp_min(rms, 1.0)
        new_p[k] = (p - lr * (update + cfg.weight_decay * p)).to(p.dtype)
    return new_p, {"f": new_f}, {"lr": lr, "grad_norm": gnorm}


__all__ = ["OptConfig", "lr_schedule", "adamw_init", "adamw_update",
           "adafactor_init", "adafactor_update", "global_norm",
           "clip_by_global_norm"]
