#!/usr/bin/env python3
"""Time the selective-scan backward kernel (B8) against variants that each
undo one step of its design, on one NVIDIA Hopper GPU.

    python3 tools/scan_bwd_steps.py

Variants, made from ``src/repro_torch/kernels/csrc/selective_scan.cu`` by
one textual change each and built with the port's nvcc flags into
``build/repro_torch/variants/``:

* ``design`` — the source as it is;
* ``three_exps`` — the reverse walk computes a_bar again (three exps per
  state and step) instead of reusing the recomputation's;
* ``three_blocks`` — ``__launch_bounds__`` asks for three blocks per SM, so
  ptxas caps the registers and spills.

Each runs at the training path's shape ([2, 2048, 8192], N 16, chunk 256),
checked bit-equal to ``design``, timed with CUDA events in the order
design, three_exps, three_blocks, three_blocks, three_exps, design. Prints
each variant's ptxas line and times, then one JSON object and the card's
name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 2048, 8192, 16, 256)          # B, S, Di, N, chunk
REUSE = "            const float ab = abr[i][s];\n"
BOUNDS = "__launch_bounds__(BwdShape<NP>::kThreads)"
VARIANTS = {
    "design": [],
    "three_exps": [(REUSE, "            const float ab = expf(dtv * av[s]);\n")],
    "three_blocks": [(BOUNDS, "__launch_bounds__(BwdShape<NP>::kThreads, 3)")],
}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import selective_scan as ss

    src = (build.CSRC / "selective_scan.cu").read_text()
    out_dir = build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"{name}: the line to change is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        m = re.search(r"ssm_bwdILi16E.*?\n\s*(\d+) bytes stack frame.*?\n.*?"
                      r"Used (\d+) registers", log, re.S)
        ptxas[name] = {"stack_frame": int(m.group(1)),
                       "registers": int(m.group(2))}
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, (restype, argtypes) in ss._SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
        print(f"{name}: ssm_bwd<16> {ptxas[name]}", flush=True)

    dev = torch.device("cuda", 0)
    B, S, Di, N, chunk = SHAPE
    rng = np.random.default_rng(12)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    a = -np.tile(np.arange(1, N + 1, dtype=np.float32), (Di, 1))
    a *= rng.uniform(0.5, 1.5, (Di, N)).astype(np.float32)
    xc, dt = f(rng.normal(0, 1, (B, S, Di))), f(np.log1p(np.exp(
        rng.normal(-4.6, 1.0, (B, S, Di)))))
    bm, cm = f(rng.normal(0, 1, (B, S, N))), f(rng.normal(0, 1, (B, S, N)))
    a, h0, dy = f(a), f(np.zeros((B, Di, N))), f(rng.normal(0, 1, (B, S, Di)))
    _, ckpt, _ = ss.selective_scan_fwd_cuda(xc, dt, bm, cm, a, h0, chunk=chunk)

    def run(name):
        ss._lib = lambda: libs[name]
        return ss.selective_scan_bwd_cuda(xc, dt, bm, cm, a, ckpt, dy,
                                          chunk=chunk)

    want = run("design")
    for name in VARIANTS:
        if not all(torch.equal(g, w) for g, w in zip(run(name), want)):
            sys.exit(f"{name} differs from design")

    def time_ms(name, reps=10):
        for _ in range(2):
            run(name)
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run(name)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    order = ["design", "three_exps", "three_blocks"]
    times = {name: [] for name in order}
    for name in order + order[::-1]:
        times[name].append(time_ms(name))
        print(f"{name}: {times[name][-1]:.4f} ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"shape": list(SHAPE), "ptxas": ptxas, "ms": times,
                      "bit_equal": True}))
    print(card)


if __name__ == "__main__":
    main()
