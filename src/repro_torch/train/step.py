"""Train-step builder: loss + grad + clip + optimizer update, with optional
microbatch gradient accumulation; port of ``src/repro/train/step.py``.

The state is {"params": {name: Parameter}, "opt": optimizer state, "step":
int}; the step writes the new parameters into the model's own tensors in
place (the reference returns new arrays), so the model and the state stay
one set of weights.

Under a ``DeviceMesh`` the parameters, the optimizer state and the batch
are DTensors (``sharding.rules.distribute_params``,
``train.state.place_train_state``, ``sharding.rules.distribute_batch``);
the model runs once a rank (``Model.loss``) and its loss is the sum of the
ranks' parts, each rank differentiating its own. A gradient comes back as
each rank's part of a sum over the data axes (a ``Partial``), so the step
puts every gradient into its parameter's layout (``_constrain_like_params``:
a reduce-scatter, the reference's ``accum_rs``) before the optimizer sees
it, and each new optimizer leaf back into its old layout (the reference's
``out_shardings``). On one device both are the identity, so
``constrain_accum`` changes nothing there.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..sharding.spmd import full_value
from .optimizer import OptConfig, adafactor_update, adamw_update


def _constrain_like_params(tree: dict, like: dict) -> dict:
    """Pin a grad-shaped dict to the layout of ``like`` (the parameters),
    so per-microbatch gradients are reduce-scattered into shards (the
    reference's ``with_sharding_constraint``, variant ``accum_rs``). A
    leaf that is not a DTensor (one device) is returned as it is."""
    return {k: _like(g, like[k]) for k, g in tree.items()}


def _like(x, ref):
    """``x`` in the layout of ``ref`` (a DTensor not yet in it is
    redistributed)."""
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(
            ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def _like_leaves(new, old):
    """``new`` (an optimizer state) with each DTensor leaf in the layout of
    ``old``'s leaf at the same place."""
    if isinstance(new, dict):
        return {k: _like_leaves(v, old[k]) for k, v in new.items()}
    return _like(new, old)


def microbatches(batch: dict, accum_steps: int) -> list:
    """``batch`` cut into ``accum_steps`` microbatches of contiguous rows
    (the reference's reshape). A meshed run cuts the host batch so and
    places each microbatch (``sharding.rules.distribute_batch``), so the
    step never gathers a placed batch back."""
    if any(isinstance(v, DTensor) for v in batch.values()):
        raise ValueError("a placed batch cannot be cut into microbatches: "
                         "cut the host batch with microbatches() and "
                         "place each")
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} is not a multiple of "
                         f"accum_steps {accum_steps}")
    mb = b // accum_steps
    return [{k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            for i in range(accum_steps)]


def make_train_step(model, opt_cfg: OptConfig, optimizer: str = "adamw",
                    accum_steps: int = 1, constrain_accum: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``accum_steps > 1`` splits the batch's leading dim into microbatches
    (contiguous rows, as the reference's reshape) and accumulates gradients
    in f32 before one optimizer update; under a mesh ``batch`` is then the
    list of placed microbatches (``microbatches`` of the host batch).
    ``constrain_accum`` shards the accumulation buffer like the parameters
    (under a mesh every gradient is put in its parameter's layout anyway).
    """
    update_fn = adamw_update if optimizer == "adamw" else adafactor_update

    def grads_of(params: dict, batch: dict):
        loss, metrics = model.loss(batch)
        # under a mesh each rank differentiates its own part of the loss
        own = loss.to_local() if isinstance(loss, DTensor) else loss
        grads = torch.autograd.grad(own, list(params.values()))
        return full_value(loss), metrics, _constrain_like_params(
            dict(zip(params, grads)), params)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        if accum_steps == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            micro = batch if isinstance(batch, (list, tuple)) \
                else microbatches(batch, accum_steps)
            if len(micro) != accum_steps:
                raise ValueError(f"{len(micro)} microbatches, not "
                                 f"accum_steps {accum_steps}")
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
            if constrain_accum:
                grads = _constrain_like_params(grads, params)
            for mb_batch in micro:
                mb_loss, _, mb_grads = grads_of(params, mb_batch)
                grads = {k: grads[k] + mb_grads[k].to(torch.float32)
                         / accum_steps for k in grads}
                if constrain_accum:
                    grads = _constrain_like_params(grads, params)
                loss = loss + mb_loss / accum_steps
            metrics = {}

        with torch.no_grad():
            new_params, new_opt, opt_metrics = update_fn(
                opt_cfg, {k: p.detach() for k, p in params.items()},
                _constrain_like_params(grads, params), state["opt"],
                state["step"])
            new_params = _constrain_like_params(new_params, params)
            for k, p in params.items():
                new = new_params[k]
                if isinstance(p, DTensor):   # the shards, in place
                    p, new = p.to_local(), new.to_local()
                p.copy_(new)
        new_state = {"params": params,
                     "opt": _like_leaves(new_opt, state["opt"]),
                     "step": state["step"] + 1}
        out_metrics = {"loss": full_value(loss),
                       **{k: full_value(v) for k, v in opt_metrics.items()}}
        out_metrics.update({k: full_value(v) for k, v in metrics.items()
                            if torch.is_tensor(v) and v.dim() == 0})
        return new_state, out_metrics

    return train_step


__all__ = ["make_train_step", "microbatches"]
