"""Carry the JAX package's parameters into the port (no twin in ``repro``).

The reference keeps its parameters as a nested dict with the blocks stacked
on a leading layer axis by ``jax.vmap`` (``src/repro/models/model.py``,
``init_params``); the port's ``Model`` has one module per layer.
``flatten_reference`` maps such a tree (of parameters, or of gradients) to
the port's parameter names, unstacking the blocks (whisper's encoder
blocks too) and numbering the list of DeepSeek's leading dense blocks
(``dense_blocks.<i>.*``); top-level leaves (whisper's ``pos_embed``) keep
their names. ``load_reference_params`` copies it into a model, so a test
can hand the same parameters to both packages and compare gradients leaf
by leaf.
"""
from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def flatten_reference(tree: dict) -> dict[str, np.ndarray]:
    """Reference tree -> {port parameter name: array}: ``blocks`` and
    ``enc_blocks`` are unstacked along their leading layer axis into
    ``blocks.<i>.*`` and ``enc_blocks.<i>.*``, and a list (``dense_blocks``,
    or the port's own ``Model.params()`` blocks) is numbered in order."""
    out: dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key in ("blocks", "enc_blocks") and isinstance(sub, dict):
            stacked: dict[str, np.ndarray] = {}
            _flatten(sub, "", stacked)
            n_layers = len(next(iter(stacked.values())))
            for i in range(n_layers):
                for name, arr in stacked.items():
                    out[f"{key}.{i}.{name}"] = arr[i]
        else:
            _flatten(sub, f"{key}.", out)
    return out


def load_reference_params(model: torch.nn.Module, tree: dict) -> None:
    """Copy the reference's parameter tree (numpy leaves) into ``model``'s
    parameters, in place. Names and shapes must match exactly."""
    named = flatten_reference(tree)
    params = dict(model.named_parameters())
    if set(named) != set(params):
        raise ValueError(f"parameter names differ: only in the reference "
                         f"{sorted(set(named) - set(params))}, only in the "
                         f"port {sorted(set(params) - set(named))}")
    with torch.no_grad():
        for name, p in params.items():
            src = torch.from_numpy(np.array(named[name]))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {tuple(src.shape)} "
                                 f"vs port {tuple(p.shape)}")
            p.copy_(src.to(p.dtype))


__all__ = ["flatten_reference", "load_reference_params"]
