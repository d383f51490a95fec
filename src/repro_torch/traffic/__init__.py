from .patterns import (
    random_uniform,
    transpose,
    permutation,
    hotspot,
    TRAFFIC_PATTERNS,
    make_traffic,
    unit_injection_scale,
)

__all__ = [
    "random_uniform", "transpose", "permutation", "hotspot",
    "TRAFFIC_PATTERNS", "make_traffic", "unit_injection_scale",
]
