"""The program's ``genomes.dispatch_faults`` span a call: geometry, the
enqueue of every launch and each of the BFS's flag reads, so a host
boundary that holds device waits, not a device time."""
LAYER = "dse.genomes dispatch"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "evals_per_s"


def read(r):
    if not r.spans or "genomes.dispatch_faults" not in r.spans or not r.calls:
        return None
    return r.spans["genomes.dispatch_faults"] / r.calls * 1e3
