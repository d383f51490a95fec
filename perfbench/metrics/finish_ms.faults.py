"""The program's ``genomes.finish_faults`` span a call: the copies of the
grid's results to the host and the host report columns (the wait on the
device's last event comes before the span opens)."""
LAYER = "dse.genomes finish"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "evals_per_s"


def read(r):
    if not r.spans or "genomes.finish_faults" not in r.spans or not r.calls:
        return None
    return r.spans["genomes.finish_faults"] / r.calls * 1e3
