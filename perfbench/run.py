"""Benchmark entry: one cell, one run, one process.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It measures the PyTorch/CUDA port
(``src/repro_torch``) on the card and exits non-zero, printing no result,
where there is no card (or fewer than the cell asks for), where the port is
not beside it, or where JAX or the JAX package got loaded. The last line of
standard output is the result object; the compared numbers and their limits
close standard error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THREAD_POOLS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch beside {ROOT / 'perfbench'}: nothing to "
              f"measure", file=sys.stderr)
        return 2
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # transformers and friends load JAX where they find it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    from perfbench import harness

    manifest = harness.load_manifest(ROOT)
    try:
        spec = harness.find_cell(manifest, ROOT, args.workload)
    except KeyError as exc:
        print(exc.args[0], file=sys.stderr)
        return 2
    chips = spec["cell"]["chips"]
    # the host's thread pools are a setting of the deployment, stated in
    # its configuration file, and set before NumPy or torch loads
    threads = spec["config"].get("host_threads")
    if threads is not None:
        for var in THREAD_POOLS:
            os.environ[var] = str(int(threads))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 3
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
