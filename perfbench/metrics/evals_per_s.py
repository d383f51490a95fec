"""Design-scenario evaluations completed in the window over its seconds:
the cost function's throughput."""
SOURCE = "host_clock"
UNIT = "evals/s"


def read(r):
    if not r.window_s:
        return None
    return r.evaluations / r.window_s
