"""The 95th percentile (nearest rank) over every call of the window of one
call's time from the start of its repair to its result in hand: what one
optimizer generation waits."""
import math

SOURCE = "host_clock"
UNIT = "ms"


def read(r):
    if not r.call_s:
        return None
    ordered = sorted(r.call_s)
    return ordered[math.ceil(0.95 * len(ordered)) - 1] * 1e3
