"""Readings that the limits of a cell's comparison are set from, on the card,
in one process (the benchmark's own runs never run this):

    python3 perfbench/calibrate.py --workload adj256-faults \\
        --seeds 11,12,...  --control-seeds 21,22,23 --seconds 4

For each ``--seeds`` seed, a short run of the cell's own load through the
program, compared with the float64 reference: the lower readings. For each
``--control-seeds`` seed, the same run with the control in the program's
place: the reference's repair, then the reference computed in bfloat16
(``precision="bfloat16"``), compared the same way: the upper readings.
Each run is one JSON line on standard output and in
``chiprun_out/calibrate_<cell>.jsonl``; a summary (the largest program
reading and the smallest control reading of each number) ends the output.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


class _Done:
    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


def control_program(n: int, max_degree: int, device: str) -> dict:
    """The reference in the program's place, in bfloat16."""
    from perfbench.reference import grid, repair

    def make_repair(space):
        return lambda raw: repair.repair(raw, n, max_degree)

    def make_evaluate(engine):
        def evaluate(space, genomes, link_fail, node_fail):
            return _Done(grid.evaluate(genomes, link_fail, node_fail, n,
                                       max_degree, device=device,
                                       precision="bfloat16"))
        return evaluate

    return {"repair": make_repair, "evaluate": make_evaluate}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seconds", type=float, default=None,
                    help="the control's window (default --seconds); the "
                         "control computes inside its dispatch, so give it "
                         "room for as many calls as the cell compares")
    args = ap.parse_args(argv)
    from perfbench import harness

    spec = harness.find_cell(harness.load_manifest(ROOT), ROOT,
                             args.workload)
    n = int(spec["config"]["n_chiplets"])
    maxd = int(spec["config"]["max_degree"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    lines = []
    control_s = args.control_seconds or args.seconds
    runs = [("program", int(s), None, args.seconds)
            for s in args.seeds.split(",") if s]
    runs += [("control", int(s), control_program(n, maxd, "cuda"),
              control_s) for s in args.control_seeds.split(",") if s]
    with open(out_dir / f"calibrate_{args.workload}.jsonl", "a") as f:
        for side, seed, program, seconds in runs:
            t = time.perf_counter()
            result = harness.run(ROOT, args.workload, seed, seconds,
                                 False, time.perf_counter(),
                                 program=program)
            line = {"side": side, "seed": seed,
                    "seconds": time.perf_counter() - t,
                    "calls": result["attempted"],
                    "correct": result["correct"],
                    "readings": {k: v["value"]
                                 for k, v in result["checks"].items()}}
            lines.append(line)
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    summary = {}
    for side, pick in (("program", max), ("control", min)):
        rows = [ln["readings"] for ln in lines if ln["side"] == side]
        if rows:
            summary[side] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"summary": summary,
                      "total_s": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
