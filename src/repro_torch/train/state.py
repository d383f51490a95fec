"""Train state and its sharding specs; port of ``src/repro/train/state.py``.

The state is ``{"params": {name: Parameter}, "opt": optimizer state,
"step": int}``: the model's own parameters (the train step writes the new
values into them in place), the optimizer's moments as flat dicts keyed
like the parameters, and a host step counter. On a ``DeviceMesh``
``train_state_shardings`` gives each leaf its ``NamedSharding`` and
``place_train_state`` puts a fresh or restored state into them.
"""
from __future__ import annotations

from typing import Any

from ..sharding.annotate import DEFAULT_RULES, NamedSharding, PartitionSpec
from ..sharding.rules import param_specs
from ..sharding.spmd import place

TrainState = dict[str, Any]   # {"params", "opt", "step"}


def init_train_state(model, optimizer_init) -> TrainState:
    """The state of a fresh run of ``model`` under ``optimizer_init``
    (``adamw_init`` or ``adafactor_init``). The reference takes a PRNG key
    here; the port's ``Model`` drew its weights from its seed already."""
    params = dict(model.named_parameters())
    return {"params": params,
            "opt": optimizer_init({k: p.detach() for k, p in params.items()}),
            "step": 0}


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    return PartitionSpec()


def train_state_specs(state: TrainState, mesh,
                      rules=DEFAULT_RULES) -> TrainState:
    """Specs of every leaf of ``state``: AdamW's ``m`` and ``v`` take the
    parameter specs leaf by leaf; Adafactor's factored states (``"f"``)
    have other ranks and are replicated, as in the reference."""
    p_specs = param_specs(state["params"], mesh, rules)
    opt_specs = {k: p_specs if k in ("m", "v") else _replicated(sub)
                 for k, sub in state["opt"].items()}
    return {"params": p_specs, "opt": opt_specs, "step": PartitionSpec()}


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, v, b[k]) for k, v in a.items()}
    return fn(a, b)


def train_state_shardings(state: TrainState, mesh,
                          rules=DEFAULT_RULES) -> TrainState:
    """A ``NamedSharding`` on the ``DeviceMesh`` ``mesh`` for every tensor
    leaf of ``state``, by ``train_state_specs``; the host step counter has
    none (``None``)."""
    specs = train_state_specs(state, mesh, rules)
    out = {k: _map2(lambda s, leaf: NamedSharding(mesh, s), specs[k],
                    state[k]) for k in ("params", "opt")}
    out["step"] = None
    return out


def place_train_state(state: TrainState, mesh,
                      rules=DEFAULT_RULES) -> TrainState:
    """``state`` with each optimizer leaf placed on ``mesh`` by
    ``train_state_shardings`` (AdamW's ``m`` and ``v`` like the parameters,
    Adafactor's factored ``f`` replicated); the step stays a host int. The
    parameters are the model's own, which ``distribute_params`` placed
    already, and are checked to be in their layout."""
    shardings = train_state_shardings(state, mesh, rules)
    for k, p in state["params"].items():
        want = shardings["params"][k].placements
        if tuple(getattr(p, "placements", ())) != tuple(want):
            raise ValueError(f"parameter {k} is not placed as {want}: "
                             f"distribute_params(model, mesh) first")
    opt = _map2(lambda leaf, sh: place(leaf, sh), state["opt"],
                shardings["opt"])
    return {"params": state["params"], "opt": opt,
            "step": int(state["step"])}


__all__ = ["TrainState", "init_train_state", "train_state_specs",
           "train_state_shardings", "place_train_state"]
