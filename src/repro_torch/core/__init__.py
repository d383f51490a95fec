"""RapidChiplet core in PyTorch: the paper's contribution, held against
``repro.core``."""
from .design import (
    Chiplet, Phy, PlacedChiplet, Placement, Link, Topology, Packaging,
    Technology, TrafficEntry, Design, DesignValidationError,
    validate_design, validate_traffic,
)
from .graph import DenseGraph, build_graph, step_cost_matrix, traffic_matrix
from .latency import (
    path_cost_doubling, latency_proxy, average_latency, num_doubling_steps,
    routed_hops, routed_diameter, routed_diameter_batch,
)
from .throughput import (edge_flows, edge_flows_load, throughput_proxy,
                         bottleneck_edges, reachable_fraction)
from .reports import (
    area_report, power_report, cost_report, die_yield, die_cost,
    ReportArrays, report_arrays,
)
from .proxies import evaluate_design, prepare_arrays, DeviceArrays, EvaluationReport

__all__ = [
    "Chiplet", "Phy", "PlacedChiplet", "Placement", "Link", "Topology",
    "Packaging", "Technology", "TrafficEntry", "Design",
    "DesignValidationError", "validate_design", "validate_traffic",
    "DenseGraph", "build_graph", "step_cost_matrix", "traffic_matrix",
    "path_cost_doubling", "latency_proxy", "average_latency",
    "num_doubling_steps", "routed_hops", "routed_diameter",
    "routed_diameter_batch",
    "edge_flows", "edge_flows_load", "throughput_proxy", "bottleneck_edges",
    "reachable_fraction",
    "area_report", "power_report", "cost_report", "die_yield", "die_cost",
    "ReportArrays", "report_arrays",
    "evaluate_design", "prepare_arrays", "DeviceArrays", "EvaluationReport",
]
