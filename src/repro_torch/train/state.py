"""Train state and its sharding specs; port of ``src/repro/train/state.py``.

The state is ``{"params": {name: Parameter}, "opt": optimizer state,
"step": int}``: the model's own parameters (the train step writes the new
values into them in place), the optimizer's moments as flat dicts keyed
like the parameters, and a host step counter.
"""
from __future__ import annotations

from typing import Any

from ..sharding.annotate import DEFAULT_RULES, PartitionSpec
from ..sharding.rules import param_specs

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


__all__ = ["TrainState", "init_train_state", "train_state_specs"]
