"""Train-step builder: loss + grad + clip + optimizer update, with optional
microbatch gradient accumulation; port of ``src/repro/train/step.py``.

``constrain_accum`` pins the accumulation buffer to the parameters' layout
where the reference does (``_constrain_like_params``). On one device that
is the identity, so the step is the same with it or without it. The state
is {"params": {name: Parameter}, "opt": optimizer state, "step": int}; the
step writes the new parameters into the model's own tensors in place (the
reference returns new arrays), so the model and the state stay one set of
weights.
"""
from __future__ import annotations

import torch

from .optimizer import OptConfig, adafactor_update, adamw_update


def _constrain_like_params(tree: dict) -> dict:
    """Pin a grad-shaped dict to the parameter layout (FSDP), so a
    partitioner reduce-scatters per-microbatch gradients into shards (the
    reference's ``with_sharding_constraint``, variant ``accum_rs``). Eager
    PyTorch on one device has no partitioner and every tensor is whole, so
    this returns ``tree`` as it is."""
    return tree


def make_train_step(model, opt_cfg: OptConfig, optimizer: str = "adamw",
                    accum_steps: int = 1, constrain_accum: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum_steps > 1`` splits the batch's leading dim into microbatches and
    accumulates gradients in f32 before one optimizer update.
    ``constrain_accum`` shards the accumulation buffer like the parameters.
    """
    update_fn = adamw_update if optimizer == "adamw" else adafactor_update

    def grads_of(params: dict, batch: dict):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), metrics, dict(zip(params, grads))

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if accum_steps == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % accum_steps:
                    raise ValueError(f"batch {b} is not a multiple of "
                                     f"accum_steps {accum_steps}")
                return x.reshape(accum_steps, b // accum_steps, *x.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            if constrain_accum:
                grads = _constrain_like_params(grads)
            for i in range(accum_steps):
                mb_loss, _, mb_grads = grads_of(
                    params, {k: v[i] for k, v in micro.items()})
                if constrain_accum:
                    mb_grads = _constrain_like_params(mb_grads)
                grads = {k: grads[k] + mb_grads[k].to(torch.float32)
                         / accum_steps for k in grads}
                if constrain_accum:
                    grads = _constrain_like_params(grads)
                loss = loss + mb_loss / accum_steps
            metrics = {}

        with torch.no_grad():
            new_params, new_opt, opt_metrics = update_fn(
                opt_cfg, {k: p.detach() for k, p in params.items()}, grads,
                state["opt"], state["step"])
            for k, p in params.items():
                p.copy_(new_params[k])
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        out_metrics = {"loss": loss, **opt_metrics}
        out_metrics.update({k: v.detach() for k, v in metrics.items()
                            if torch.is_tensor(v) and v.dim() == 0})
        return new_state, out_metrics

    return train_step


__all__ = ["make_train_step"]
