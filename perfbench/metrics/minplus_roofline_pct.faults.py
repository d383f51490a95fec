"""The min-plus next-hop selection's share of its roofline in the traced
calls: the least time for the calls' selections
(``roofline.minplus_selection``) over the profiler's device time of the
``minplus`` kernels."""
from perfbench import roofline

LAYER = "kernels"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "evals_per_s"


def read(r):
    d = r.device
    if not d:
        return None
    spent = sum(s for name, s in d["kernel_s"].items() if "minplus" in name)
    if spent <= 0:
        return None
    bound = roofline.minplus_selection(d["rows"], d["n"],
                                      d["max_degree"])["seconds"]
    return 100.0 * d["calls"] * bound / spent
