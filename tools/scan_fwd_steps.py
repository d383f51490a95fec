#!/usr/bin/env python3
"""Time the selective-scan forward kernel (B7) against variants that each
undo one step of its design, on one NVIDIA Hopper GPU.

    python3 tools/scan_fwd_steps.py

Variants, each built with the port's nvcc flags into
``build/repro_torch/variants/``:

* ``design`` — ``src/repro_torch/kernels/csrc/selective_scan.cu`` as it is
  (``kFwdLanes`` = 4 lanes a channel, the next tile's copies in flight
  during this one's steps);
* ``lanes2``, ``lanes8`` — 2 or 8 lanes a channel (``kFwdLanes``);
* ``no_prefetch`` — a tile's steps wait for the next tile's copies too
  (``cp_async_wait<0>``), so no load is in flight during them;
* ``unroll1``, ``unroll2``, ``unroll4`` — the step loop of a tile unrolled
  1, 2 or 4 times by a ``#pragma unroll`` (the design leaves it to nvcc);
* ``one_thread`` — the first design, kept here as ``ONE_THREAD_SOURCE``: one
  thread per (sequence, channel) holding all N states, 64-thread blocks,
  B_t and C_t staged 16 steps at a time, x and dt loaded into registers.

Every variant updates the states with the same ``step_state``, so its
checkpoints and final states are checked bit-equal to ``one_thread``'s; y
sums over N in another order and is checked within rtol 1e-4 / atol 1e-5
of ``design``'s. Each runs at the training path's shape ([2, 2048, 8192],
N 16, chunk 256), timed with CUDA events in the variants' order and then in
reverse. Prints each variant's ptxas line (N = 16) and times, then one JSON
object and the card's name and power limit.

``chip_smoke.py`` builds ``one_thread`` beside the port's sources and holds
the forward kernel's checkpoints and final states bit-equal to it.
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
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
LANES = "constexpr int kFwdLanes = 4;"
PREFETCH = ("    cp_async_wait<1>();              "
            "// tile k has landed, k + 1 in flight\n")
STEPS = "    for (int tt = 0; tt < tn; ++tt) {\n      const int t = t0 + tt;\n"
EDITS = {
    "design": [],
    "lanes2": [(LANES, "constexpr int kFwdLanes = 2;")],
    "lanes8": [(LANES, "constexpr int kFwdLanes = 8;")],
    "no_prefetch": [(PREFETCH, "    cp_async_wait<0>();\n")],
    "unroll1": [(STEPS, "#pragma unroll 1\n" + STEPS)],
    "unroll2": [(STEPS, "#pragma unroll 2\n" + STEPS)],
    "unroll4": [(STEPS, "#pragma unroll 4\n" + STEPS)],
}
VARIANTS = (*EDITS, "one_thread")

ONE_THREAD_SOURCE = r"""#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 64;   // channels per block
constexpr int kTile = 16;         // steps staged per tile

// One recurrence step of one state, h <- exp(dt a) h + (dt x) b; returns
// a_bar. The forward and both backward passes use it, so the backward's
// recomputed states equal the forward's bit for bit.
__device__ __forceinline__ float step_state(float& h, float a, float dtv,
                                            float dx, float b) {
  const float ab = expf(dtv * a);
  h = fmaf(ab, h, dx * b);
  return ab;
}

// One recurrence step of a channel's states (the forward's form).
template <int NP>
__device__ __forceinline__ void advance(float (&h)[NP], const float (&av)[NP],
                                        float dtv, float xv, const float* bt,
                                        int N) {
  const float dx = dtv * xv;
#pragma unroll
  for (int n = 0; n < NP; ++n)
    if (n < N) step_state(h[n], av[n], dtv, dx, bt[n]);
}

template <int NP>
__global__ void __launch_bounds__(kFwdThreads)
ssm_fwd_one_thread(const float* __restrict__ xc,
                   const float* __restrict__ dt,
                   const float* __restrict__ bm,
                   const float* __restrict__ cm,
                   const float* __restrict__ a,
                   const float* __restrict__ h0, float* __restrict__ y,
                   float* __restrict__ ckpt, float* __restrict__ ht, int S,
                   int Di, int N, int chunk) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kFwdThreads + threadIdx.x;
  const bool live = d < Di;
  const int n_chunks = S / chunk;
  __shared__ float sb[kTile][NP];
  __shared__ float sc[kTile][NP];

  float h[NP], av[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    const bool ok = live && n < N;
    h[n] = ok ? h0[((size_t)b * Di + d) * N + n] : 0.f;
    av[n] = ok ? a[(size_t)d * N + n] : 0.f;
  }
  const float* X = xc + (size_t)b * S * Di;
  const float* T = dt + (size_t)b * S * Di;
  const float* Bm = bm + (size_t)b * S * N;
  const float* Cm = cm + (size_t)b * S * N;
  float* Y = y + (size_t)b * S * Di;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int tn = min(kTile, S - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * NP; e += kFwdThreads) {
      const int tt = e / NP, n = e % NP;
      const bool ok = tt < tn && n < N;
      sb[tt][n] = ok ? Bm[(size_t)(t0 + tt) * N + n] : 0.f;
      sc[tt][n] = ok ? Cm[(size_t)(t0 + tt) * N + n] : 0.f;
    }
    float xr[kTile], dr[kTile];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      const bool ok = live && tt < tn;
      xr[tt] = ok ? X[(size_t)(t0 + tt) * Di + d] : 0.f;
      dr[tt] = ok ? T[(size_t)(t0 + tt) * Di + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < tn && live) {
        const int t = t0 + tt;
        if (t % chunk == 0) {
          float* ck = ckpt + (((size_t)b * n_chunks + t / chunk) * Di + d) * N;
#pragma unroll
          for (int n = 0; n < NP; ++n)
            if (n < N) ck[n] = h[n];
        }
        advance<NP>(h, av, dr[tt], xr[tt], sb[tt], N);
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NP; ++n)
          if (n < N) acc += h[n] * sc[tt][n];
        Y[(size_t)t * Di + d] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < N) ht[((size_t)b * Di + d) * N + n] = h[n];
  }
}

}  // namespace

extern "C" int ssm_fwd_launch(const float* xc, const float* dt,
                              const float* bm, const float* cm,
                              const float* a, const float* h0, float* y,
                              float* ckpt, float* ht, int B, int S, int Di,
                              int N, int chunk, void* stream) {
  if (N < 1 || N > 16 || chunk < 1 || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Di + kFwdThreads - 1) / kFwdThreads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ONE_THREAD(NP)                                                      \
  ssm_fwd_one_thread<NP><<<grid, kFwdThreads, 0, st>>>(                     \
      xc, dt, bm, cm, a, h0, y, ckpt, ht, S, Di, N, chunk);
  if (N <= 4) {
    ONE_THREAD(4)
  } else if (N <= 8) {
    ONE_THREAD(8)
  } else {
    ONE_THREAD(16)
  }
#undef ONE_THREAD
  return (int)cudaGetLastError();
}

extern "C" const char* ssm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def _src_path():
    sys.path.insert(0, os.path.join(ROOT, "src"))


def variant_source(name: str) -> str:
    """The CUDA source of one variant."""
    if name == "one_thread":
        return ONE_THREAD_SOURCE
    _src_path()
    from repro_torch.kernels import build

    text = (build.CSRC / "selective_scan.cu").read_text()
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the line to change is not in the "
                               f"source: {old}")
        text = text.replace(old, new)
    return text


def start_build(name: str):
    """Start nvcc for one variant; returns a handle for ``finish_build``."""
    _src_path()
    from repro_torch.kernels import build

    out_dir = build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"scan_fwd_{name}.cu"
    cu.write_text(variant_source(name))
    so = out_dir / f"libscan_fwd_{name}.so"
    proc = subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                             str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, so


def finish_build(handle) -> tuple[ctypes.CDLL, str]:
    """Wait for one variant's nvcc; returns (library, nvcc/ptxas log).
    Raises if the build failed."""
    from repro_torch.kernels import selective_scan as ss

    name, proc, so = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
    lib = ctypes.CDLL(str(so))
    for fn in ("ssm_fwd_launch", "ssm_error_string"):
        restype, argtypes = ss._SIGNATURES[fn]
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib, log


def forward(lib, xc, dt, bm, cm, a, h0, chunk: int):
    """One launch of a variant's forward kernel on the current stream
    (operands as ``selective_scan_fwd_cuda`` takes them); returns
    (y, ckpt, hT)."""
    import torch

    B, S, Di = xc.shape
    N = a.shape[1]
    y = torch.empty_like(xc)
    ckpt = torch.empty((B, S // chunk, Di, N), dtype=torch.float32,
                       device=xc.device)
    ht = torch.empty_like(h0)
    stream = torch.cuda.current_stream(xc.device)
    with torch.cuda.device(xc.device):
        rc = lib.ssm_fwd_launch(
            xc.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), h0.data_ptr(), y.data_ptr(), ckpt.data_ptr(),
            ht.data_ptr(), B, S, Di, N, chunk, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant forward launch failed: "
                           f"{lib.ssm_error_string(rc).decode()}")
    return y, ckpt, ht


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    handles = [start_build(name) for name in VARIANTS]
    libs, ptxas = {}, {}
    for handle in handles:
        name = handle[0]
        libs[name], log = finish_build(handle)
        m = re.search(r"ssm_fwd\w*ILi16E.*?\n\s*(\d+) bytes stack frame.*?"
                      r"\n.*?Used (\d+) registers", log, re.S)
        ptxas[name] = {"stack_frame": int(m.group(1)),
                       "registers": int(m.group(2))}
        print(f"{name}: ssm_fwd<16> {ptxas[name]}", flush=True)

    dev = torch.device("cuda", 0)
    B, S, Di, N, chunk = SHAPE
    rng = np.random.default_rng(12)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    a = -np.tile(np.arange(1, N + 1, dtype=np.float32), (Di, 1))
    a *= rng.uniform(0.5, 1.5, (Di, N)).astype(np.float32)
    xc, dt = f(rng.normal(0, 1, (B, S, Di))), f(np.log1p(np.exp(
        rng.normal(-4.6, 1.0, (B, S, Di)))))
    bm, cm = f(rng.normal(0, 1, (B, S, N))), f(rng.normal(0, 1, (B, S, N)))
    a, h0 = f(a), f(rng.normal(0, 0.3, (B, Di, N)))

    def run(name):
        return forward(libs[name], xc, dt, bm, cm, a, h0, chunk)

    base, want = run("one_thread"), run("design")
    for name in VARIANTS:
        y, ckpt, ht = run(name)
        if not (torch.equal(ckpt, base[1]) and torch.equal(ht, base[2])):
            sys.exit(f"{name}: checkpoints or final states differ from "
                     f"one_thread's")
        if not torch.allclose(y, want[0], **FWD_TOL):
            sys.exit(f"{name}: y differs from design's beyond {FWD_TOL}")

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

    times = {name: [] for name in VARIANTS}
    for name in VARIANTS + VARIANTS[::-1]:
        times[name].append(time_ms(name))
        print(f"{name}: {times[name][-1]:.4f} ms", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"shape": list(SHAPE), "ptxas": ptxas, "ms": times,
                      "states_bit_equal": True}))
    print(card)


if __name__ == "__main__":
    main()
