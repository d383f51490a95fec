"""Interconnect-aware sharding advisor; port of
``src/repro/sharding/autoshard.py``.

Uses the paper's latency/throughput proxies, applied to the pod's own
interconnect (``core/ici_model.py``), as the cost function for choosing
which logical axis maps to which mesh axis: the "cost function for
optimization algorithms" role RapidChiplet proposes, pointed at the
machine it runs on.

The advisor estimates per-step collective traffic for a model config
under each candidate rule set, prices every collective with the proxy
(congestion-aware: an all-to-all over a mesh row and a torus ring differ
by the relayed flows load propagation finds), and ranks the candidates.
``link_bw`` and ``device`` pass through to ``estimate_collective``.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.ici_model import NVLINK4_LINK_BW, estimate_collective
from ..models.config import ModelConfig


@dataclass(frozen=True)
class CollectiveDemand:
    kind: str            # all_gather | reduce_scatter | all_reduce | all_to_all
    axis: str            # mesh axis it runs over
    bytes_per_device: float
    count_per_step: int
    tag: str


def training_collective_demand(cfg: ModelConfig, global_batch: int,
                               seq_len: int, data_ways: int, model_ways: int,
                               rules_name: str = "default"
                               ) -> list[CollectiveDemand]:
    """Analytic per-step collective traffic of the FSDP+TP training layout.

    Megatron-style TP: 2 activation all-reduces per layer forward, 2 in
    backward (sequence-parallel halves this: the autoshard candidate).
    FSDP: per-layer param all-gather (fwd + bwd) + gradient reduce-scatter.
    MoE: dispatch/combine all-to-alls over the expert axis.
    """
    bytes_act = (global_batch // max(data_ways, 1)) * seq_len * cfg.d_model * 2
    demands = []
    l = cfg.n_layers
    seq_parallel = rules_name == "seq_parallel"
    act_kind = "reduce_scatter" if seq_parallel else "all_reduce"
    act_count = 4 * l   # 2 fwd + 2 bwd per layer
    demands.append(CollectiveDemand(act_kind, "model", bytes_act, act_count,
                                    "tp_activations"))
    if seq_parallel:
        demands.append(CollectiveDemand("all_gather", "model", bytes_act,
                                        act_count, "sp_regather"))
    # FSDP param gathers: per layer, params/layer bytes (bf16), fwd+bwd
    params_per_layer = max(cfg.n_params() // max(l, 1), 1)
    bytes_params = params_per_layer * 2 / max(data_ways, 1)
    demands.append(CollectiveDemand("all_gather", "data", bytes_params,
                                    2 * l, "fsdp_gather"))
    demands.append(CollectiveDemand("reduce_scatter", "data",
                                    params_per_layer * 4 / max(data_ways, 1),
                                    l, "grad_reduce"))
    if cfg.is_moe:
        bytes_tokens = (global_batch // max(data_ways, 1)) * seq_len * \
            cfg.d_model * 2 * cfg.top_k
        demands.append(CollectiveDemand("all_to_all", "model", bytes_tokens,
                                        2 * l, "moe_dispatch_combine"))
    return demands


def price_demands(demands: list[CollectiveDemand], rows: int = 16,
                  cols: int = 16, wrap: bool = True,
                  link_bw: float = NVLINK4_LINK_BW, device=None) -> dict:
    """Price each collective with the RapidChiplet proxy on the pod's
    interconnect (on ``device``, None -> cuda)."""
    total_s = 0.0
    per_tag = {}
    for d in demands:
        est = estimate_collective(d.kind, d.axis, d.bytes_per_device,
                                  rows=rows, cols=cols, wrap=wrap,
                                  link_bw=link_bw, device=device)
        t = est.proxy_s * d.count_per_step
        per_tag[d.tag] = per_tag.get(d.tag, 0.0) + t
        total_s += t
    return {"total_s": total_s, "per_tag": per_tag}


def rank_layouts(cfg: ModelConfig, global_batch: int, seq_len: int,
                 mesh_shape: dict, wrap: bool = True,
                 link_bw: float = NVLINK4_LINK_BW, device=None) -> list[dict]:
    """Rank candidate rule sets by proxy-priced collective time/step."""
    data_ways = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    model_ways = mesh_shape.get("model", 1)
    out = []
    for rules_name in ("default", "seq_parallel"):
        demands = training_collective_demand(
            cfg, global_batch, seq_len, data_ways, model_ways, rules_name)
        priced = price_demands(demands, wrap=wrap, link_bw=link_bw,
                               device=device)
        out.append({"rules": rules_name, **priced})
    out.sort(key=lambda r: r["total_s"])
    return out


__all__ = ["CollectiveDemand", "training_collective_demand", "price_demands",
           "rank_layouts"]
