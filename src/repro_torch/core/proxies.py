"""End-to-end design evaluation: the RapidChiplet core (paper Fig. 1); port
of ``src/repro/core/proxies.py``.

``evaluate_design`` = validate -> build graph -> routing table -> latency &
throughput proxies -> area/power/cost reports. Graph and routing are numpy
on the host; the proxies run on ``device`` (None -> cuda). ``prepare_arrays``
exposes the dense arrays the batched DSE engine (``repro_torch.dse``) pads
and stacks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .design import Design, validate_design
from .graph import DenseGraph, build_graph, step_cost_matrix
from .latency import average_latency, routed_diameter
from .throughput import throughput_proxy
from .reports import (AreaReport, CostReport, PowerReport, area_report,
                      cost_report, power_report)
from ..routing.tables import build_routing_table
from ..utils.device import resolve_device


@dataclass
class DeviceArrays:
    """Dense, fixed-shape host arrays the proxies consume."""
    next_hop: np.ndarray     # int32 [n, n]
    step_cost: np.ndarray    # f32  [n, n]  (node_weight[u] + edge latency)
    node_weight: np.ndarray  # f32  [n]
    adj_bw: np.ndarray       # f32  [n, n]
    n_chiplets: int


@dataclass
class EvaluationReport:
    latency: float             # cycles, traffic-weighted mean packet latency
    throughput: float          # fraction of offered load sustained
    area: AreaReport
    power: PowerReport
    cost: CostReport

    def to_dict(self) -> dict:
        return {
            "latency": self.latency,
            "throughput": self.throughput,
            "total_chiplet_area": self.area.total_chiplet_area,
            "interposer_area": self.area.interposer_area,
            "power": self.power.total,
            "cost": self.cost.total,
        }


def prepare_arrays(design: Design, validate: bool = True
                   ) -> tuple[DeviceArrays, DenseGraph]:
    if validate:
        validate_design(design)
    g = build_graph(design)
    next_hop = build_routing_table(g, design.routing, design.routing_metric,
                                   design.seed)
    sc = step_cost_matrix(g)
    sc = np.where(np.isfinite(sc), sc, 0.0)   # never gathered for valid tables
    arrays = DeviceArrays(
        next_hop=next_hop.astype(np.int32),
        step_cost=sc.astype(np.float32),
        node_weight=g.node_weight.astype(np.float32),
        adj_bw=g.adj_bw.astype(np.float32),
        n_chiplets=g.n_chiplets,
    )
    return arrays, g


def evaluate_design(design: Design, traffic: np.ndarray,
                    validate: bool = True, max_hops: int | None = None,
                    device: str | torch.device | None = None
                    ) -> EvaluationReport:
    """Evaluate one design under one traffic pattern (paper Fig. 1 flow).
    The proxies run on ``device``; None means cuda, and raises without a
    GPU."""
    dev = resolve_device(device)
    arrays, _ = prepare_arrays(design, validate)
    nh = torch.from_numpy(arrays.next_hop).to(dev)
    t = torch.from_numpy(np.asarray(traffic, np.float32)).to(dev)
    if max_hops is None:
        # Exact routed diameter: tight static bound, no silent flow undercount.
        max_hops = max(routed_diameter(nh), 1)
    lat = float(average_latency(nh, torch.from_numpy(arrays.step_cost).to(dev),
                                torch.from_numpy(arrays.node_weight).to(dev),
                                t))
    thr = float(throughput_proxy(nh, torch.from_numpy(arrays.adj_bw).to(dev),
                                 t, max_hops=max_hops))
    return EvaluationReport(
        latency=lat, throughput=thr,
        area=area_report(design),
        power=power_report(design),
        cost=cost_report(design),
    )


__all__ = ["DeviceArrays", "EvaluationReport", "prepare_arrays",
           "evaluate_design"]
