from .patterns import (
    random_uniform,
    transpose,
    permutation,
    hotspot,
    TRAFFIC_PATTERNS,
    make_traffic,
    unit_injection_scale,
)
from .trace import parse_trace_file, write_trace_file, aggregate_trace

__all__ = [
    "random_uniform", "transpose", "permutation", "hotspot",
    "TRAFFIC_PATTERNS", "make_traffic", "unit_injection_scale",
    "parse_trace_file", "write_trace_file", "aggregate_trace",
]
