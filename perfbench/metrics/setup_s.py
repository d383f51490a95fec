"""From process start to the first timed call: CUDA start-up, kernel build
or load, the inputs' draw and the warm-up calls."""
SOURCE = "host_clock"
UNIT = "s"


def read(r):
    return r.setup_s
