"""The host repair of a call's offspring (``space.repair``), by the
benchmark's own clock around it, averaged over the window's calls."""
LAYER = "opt.space repair"
SOURCE = "host_clock"
UNIT = "ms"
MOVES = "evals_per_s"


def read(r):
    if r.repair_s is None or not r.calls:
        return None
    return r.repair_s / r.calls * 1e3
