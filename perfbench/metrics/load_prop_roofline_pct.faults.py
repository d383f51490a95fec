"""Load propagation's share of its roofline in the traced calls: the least
time the card could take for the calls' load propagation
(``roofline.load_propagation``) over the profiler's device time of the
``load_prop_hops`` and ``load_prop_flow`` kernels."""
from perfbench import roofline

LAYER = "kernels"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "evals_per_s"
KERNELS = ("load_prop_hops", "load_prop_flow")


def read(r):
    d = r.device
    if not d:
        return None
    spent = sum(s for name, s in d["kernel_s"].items()
                if any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    bound = roofline.load_propagation(d["rows"], d["n"])["seconds"]
    return 100.0 * d["calls"] * bound / spent
