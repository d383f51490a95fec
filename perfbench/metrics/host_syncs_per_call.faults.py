"""Flag reads of the routing's data-dependent loops (the program's
``routing.host_sync`` counter, every loop) a call of the window."""
LAYER = "routing.device"
SOURCE = "program_counter"
UNIT = "syncs/call"
MOVES = "evals_per_s"


def read(r):
    if not r.counters or "routing.host_sync" not in r.counters or not r.calls:
        return None
    return r.counters["routing.host_sync"] / r.calls
