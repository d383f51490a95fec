"""Path-based parameter, batch and cache sharding rules (FSDP + TP + EP);
port of ``src/repro/sharding/rules.py``.

``param_specs`` assigns each parameter a PartitionSpec from its name, the
production layout of the reference:

* FSDP: the d_model/contraction axis of every large matrix shards over
  ("pod", "data").
* TP: heads / mlp hidden / vocab / experts / ssm channels shard over
  "model".

The port's parameters are per layer (``blocks.<i>.mlp.wi``,
``dense_blocks.<i>.*``, ``enc_blocks.<i>.*``, as
``models/convert.flatten_reference`` maps the reference's stacked tree),
so a leaf has no layer axis, and its spec is the reference's without the
leading ``None`` of the stack. An expert tensor is told apart by the tree,
not by rank: it is a ``mlp.w[igo]`` of a block whose ``mlp`` has a
``router`` (a MoE block), not ``shared``.
The reference's rank test (``ndim >= 3``) also takes a dense MLP weight
stacked over layers for an expert tensor (ROADMAP Queue C); here the dense
MLP keeps the documented ("fsdp", "mlp") / ("mlp", "fsdp") layout.

There is no ``NamedSharding``: ``param_shardings`` is the spec tree itself.
"""
from __future__ import annotations

import re

from .annotate import DEFAULT_RULES, resolve_spec

# (path regex, logical axes per dim, without a layer-stack axis)
_PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    (r"embed/table$",        ("vocab", "fsdp")),
    (r"unembed/w$",          ("fsdp", "vocab")),
    (r"pos_embed$",          (None, "fsdp")),
    # attention
    (r"attn/wq$",            ("fsdp", "heads", None)),
    (r"attn/wk$",            ("fsdp", "kv_heads", None)),
    (r"attn/wv$",            ("fsdp", "kv_heads", None)),
    (r"attn/wo$",            ("heads", None, "fsdp")),
    (r"attn/b[qkv]$",        ("kv_heads", None)),
    (r"cross/wq$",           ("fsdp", "heads", None)),
    (r"cross/w[kv]$",        ("fsdp", "kv_heads", None)),
    (r"cross/wo$",           ("heads", None, "fsdp")),
    (r"cross/b[qkv]$",       ("kv_heads", None)),
    # MLA
    (r"attn/wq_a$",          ("fsdp", None)),
    (r"attn/wq_b$",          (None, "heads", None)),
    (r"attn/wkv_a$",         ("fsdp", None)),
    (r"attn/wk_b$",          (None, "heads", None)),
    (r"attn/wv_b$",          (None, "heads", None)),
    # dense MLP (incl. MoE shared expert)
    (r"mlp/(shared/)?wi$",   ("fsdp", "mlp")),
    (r"mlp/(shared/)?wg$",   ("fsdp", "mlp")),
    (r"mlp/(shared/)?wo$",   ("mlp", "fsdp")),
    # MoE experts
    (r"mlp/router$",         ("fsdp", None)),
    # mamba
    (r"ssm/in_proj$",        ("fsdp", "ssm_inner")),
    (r"ssm/conv_w$",         (None, "ssm_inner")),
    (r"ssm/conv_b$",         ("ssm_inner",)),
    (r"ssm/x_proj$",         ("ssm_inner", None)),
    (r"ssm/dt_proj$",        (None, "ssm_inner")),
    (r"ssm/dt_bias$",        ("ssm_inner",)),
    (r"ssm/a_log$",          ("ssm_inner", None)),
    (r"ssm/d_skip$",         ("ssm_inner",)),
    (r"ssm/out_proj$",       ("ssm_inner", "fsdp")),
    # norms: replicated
    (r"ln[^/]*/(scale|bias)$", ()),
)

# Expert tensors carry a leading E axis before the dense-MLP layout.
_MOE_EXPERT_RULES: tuple[tuple[str, tuple], ...] = (
    (r"mlp/wi$", ("experts", "fsdp", None)),
    (r"mlp/wg$", ("experts", "fsdp", None)),
    (r"mlp/wo$", ("experts", None, "fsdp")),
)


def path_of(name: str) -> str:
    """A port name (``blocks.3.mlp.wi``) as the reference's path string
    (``blocks/3/mlp/wi``) that the rules match."""
    return name.replace(".", "/")


def is_expert_leaf(path: str, paths) -> bool:
    """A routed expert tensor: ``mlp/w[igo]`` (not ``shared``) of a block
    whose ``mlp`` has a ``router`` among ``paths``, the tree's paths."""
    m = re.search(r"^(.*)/mlp/w[igo]$", path)
    return m is not None and f"{m.group(1)}/mlp/router" in paths


def logical_axes_for(path: str, ndim: int, is_moe_leaf: bool) -> tuple:
    """The first rule whose pattern matches ``path`` and whose axes fit
    ``ndim`` (or ``ndim - 1``, with a leading replicated axis); else every
    axis replicated. The reference's function, unchanged."""
    rules = (_MOE_EXPERT_RULES + _PARAM_RULES) if is_moe_leaf else _PARAM_RULES
    for pat, axes in rules:
        if re.search(pat, path):
            if len(axes) == ndim:
                return axes
            if len(axes) == ndim - 1:
                return (None,) + axes
            continue
    return (None,) * ndim


def param_specs(params: dict, mesh, rules=DEFAULT_RULES, cfg=None) -> dict:
    """{name: PartitionSpec} for a flat {name: tensor} parameter dict (the
    port's ``named_parameters``; any leaf with ``.shape`` and ``.dim()``).
    ``cfg`` is accepted for the reference's signature and not read: the
    tree itself tells the expert tensors apart."""
    rules_d = dict(rules)
    paths = {path_of(name) for name in params}
    out = {}
    for name, leaf in params.items():
        path = path_of(name)
        axes = logical_axes_for(path, leaf.dim(), is_expert_leaf(path, paths))
        out[name] = resolve_spec(axes, mesh, rules_d, dims=tuple(leaf.shape))
    return out


def param_shardings(params: dict, mesh, rules=DEFAULT_RULES,
                    cfg=None) -> dict:
    """The reference's ``NamedSharding`` tree; in the port, the spec tree."""
    return param_specs(params, mesh, rules, cfg)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(batch: dict, mesh, rules=DEFAULT_RULES) -> dict:
    """Input batch: shard the leading batch dim over the data axes (and the
    sequence dim when the rules enable sequence parallelism)."""
    rules_d = dict(rules)
    out = {}
    for name, leaf in batch.items():
        nd = leaf.dim()
        if name.endswith("pos") or nd == 0:
            out[name] = resolve_spec((), mesh, rules_d)
            continue
        if name.endswith(("tokens", "labels")):
            axes = ("batch", "seq")[:nd]
        elif name.endswith(("patches", "frames")):
            axes = ("batch", "seq", "embed")[:nd]
        else:
            axes = ("batch",) + (None,) * (nd - 1)
        out[name] = resolve_spec(axes, mesh, rules_d, dims=tuple(leaf.shape))
    return out


def _cache_axes(path: str, nd: int) -> tuple:
    if path.endswith(("/k", "/v", "cross_k", "cross_v")):
        # head_dim is the fallback TP axis when kv_heads doesn't divide the
        # model axis; "seq_kv" maps to "model" only under SERVING_RULES
        axes = (None, "batch", "seq_kv", "kv_heads", "head_dim")
    elif path.endswith("c_kv"):
        axes = (None, "batch", "seq_kv", None)
    elif path.endswith("k_rope"):
        axes = (None, "batch", "seq_kv", None, None)
    elif path.endswith("state"):
        axes = (None, "batch", "ssm_inner", None)
    elif path.endswith("conv"):
        axes = (None, "batch", None, "ssm_inner")
    else:
        axes = (None,) * nd
    return axes[:nd] if len(axes) >= nd else axes + (None,) * (nd - len(axes))


def cache_specs(cache, mesh, rules=DEFAULT_RULES):
    """Serving caches, stacked [L, B, S, ...] as ``Model.init_cache`` lays
    them out: batch shards over the data axes, heads/channels over model.
    Returns a tree of the cache's structure with a spec at each leaf."""
    rules_d = dict(rules)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        return resolve_spec(_cache_axes(path, node.dim()), mesh, rules_d,
                            dims=tuple(node.shape))

    return walk(cache, "")


__all__ = ["param_specs", "param_shardings", "batch_specs", "cache_specs",
           "logical_axes_for", "is_expert_leaf", "path_of"]
