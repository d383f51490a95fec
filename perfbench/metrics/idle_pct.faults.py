"""The share of the traced window in which no operation ran on the device
(kernels, copies and fills merged on the profiler's timeline)."""
LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "evals_per_s"


def read(r):
    d = r.device
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
