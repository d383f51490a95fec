#!/usr/bin/env python3
"""Time the fused APSP kernel (B3) against variants that each undo one step
of its design, on one NVIDIA Hopper GPU.

    python3 tools/apsp_steps.py

Variants, each built with the port's nvcc flags into
``build/repro_torch/variants/``:

* ``design`` — ``src/repro_torch/kernels/csrc/apsp.cu`` as it is (a cluster
  of the smallest power of two >= n / 8 CTAs, at most 8, a design; the
  design stops at its fixed point);
* ``c1``, ``c2``, ``c4``, ``c8`` — clusters of 1, 2, 4 or 8 CTAs whatever n
  (``cluster_size``);
* ``no_stop`` — every design runs all ``n_iters`` squarings
  (``kStopAtFixedPoint`` false);
* ``first`` — the first design, kept here as ``FIRST_SOURCE``: one CTA per
  design with the previous and the next iterate as two full panes in
  shared memory, 64 x 64 output tiles of 4 x 4 register blocks, all
  ``n_iters`` squarings.

Min is exact and each candidate one add, so every variant is checked
bit-equal to ``apsp_plain`` and to ``first`` over all ``n_iters``
squarings, on random cost stacks (n in {16, 32, 64}) and on the timed
operands. Each is timed with CUDA events at the device-routing path's
shape (the registry topologies at 64 chiplets, [13, 64, 64], 7
squarings), in the variants' order and then in reverse: the call between
two CUDA events, and once the profiler's device time. Prints each variant's
ptxas lines and times, the squarings each timed design needs to
reach its fixed point, then one JSON object and the card's name and power
limit.

``chip_smoke.py`` builds ``first`` beside the port's sources and holds the
kernel bit-equal to it.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK_NS = (16, 32, 64)
CLUSTER = "  while (c < kMaxCluster && c * 8 < n) c *= 2;\n  return c;\n"
STOP = "constexpr bool kStopAtFixedPoint = true;"
EDITS = {
    "design": [],
    "c1": [(CLUSTER, "  return 1;\n")],
    "c2": [(CLUSTER, "  return 2;\n")],
    "c4": [(CLUSTER, "  return 4;\n")],
    "c8": [(CLUSTER, "  return 8;\n")],
    "no_stop": [(STOP, "constexpr bool kStopAtFixedPoint = false;")],
}
VARIANTS = (*EDITS, "first")

FIRST_SOURCE = r"""// Fused all-pairs shortest paths by min-plus squaring on Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/apsp.py:71 (_apsp_kernel): the
// whole APSP of one design in one launch, with no intermediate matrix in
// device memory. (The blocked squaring of apsp.py:167 is minplus.cu's
// kernel applied to (m, m); see that file.)
//
// What it computes, per design: d is [n, n] f32 with BIG (1e18) for "no
// edge" and a zero diagonal; n_iters times
//   nxt[i, j] = min(cur[i, j], min_k cur[i, k] + cur[k, j])
// reading only the previous iterate (Jacobi, as the TPU kernel reads `d`
// and writes `acc`). Each candidate is one f32 add and min is exact in any
// order, so the result is bit-equal to the plain version
// (kernels/apsp.py:apsp_plain). An in-place Floyd-style update would sum
// paths in another association and is not used.
//
// What bounds it on the H100: the operations, B n_iters n^3 candidates of
// one FADD and one FMNMX each (add and min do not fuse), over 132 SMs x
// 128 FP32 lanes x the SM clock. The bytes are 8 B n^2 per design (d read
// once, the result written once).
//
// What the design does about it:
// * one CTA per design. The previous and the next iterate are two f32
//   [n, n] panes in dynamic shared memory, swapped after each squaring with
//   a __syncthreads between; device memory sees d once and the result once.
//   Two panes fit in a block's 232,448 bytes up to n = 170 (231,200 B),
//   which is the port's MAX_FUSED_N;
// * each squaring walks 64 x 64 output tiles; each of the 256 threads keeps
//   a 4 x 4 block of the accumulator in registers, so 8 shared-memory loads
//   feed 16 candidates;
// * one CTA per design keeps at most B of the 132 SMs busy: a small batch
//   leaves the card mostly idle. That is the price of keeping the panes in
//   shared memory; above REPRO_APSP_FUSED_N the tiled squaring spreads each
//   design over many CTAs instead;
// * no atomics, nothing that depends on the batch: a design gives the same
//   bits alone or in a batch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 block of a 64 x 64 tile
constexpr int kTile = 64;
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
apsp_fused(const float* __restrict__ d, float* __restrict__ out, int n,
           int n_iters) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;
  float* nxt = smem + (size_t)n * n;
  const size_t base = (size_t)blockIdx.x * n * n;
  const int elems = n * n;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) cur[e] = d[base + e];
  __syncthreads();

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int tiles = (n + kTile - 1) / kTile;
  for (int it = 0; it < n_iters; ++it) {
    for (int t = 0; t < tiles * tiles; ++t) {
      const int r0 = (t / tiles) * kTile;
      const int c0 = (t % tiles) * kTile;
      int rows[4], cols[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // rows/columns past n read row/column n-1 and are never stored
        rows[i] = min(r0 + ty + 16 * i, n - 1);
        cols[i] = min(c0 + tx + 16 * i, n - 1);
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = cur[rows[i] * n + cols[j]];
      for (int k = 0; k < n; ++k) {
        float ra[4], rb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ra[i] = cur[rows[i] * n + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) rb[j] = cur[k * n + cols[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fminf(acc[i][j], ra[i] + rb[j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i;
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 16 * j;
          if (c < n) nxt[r * n + c] = acc[i][j];
        }
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) out[base + e] = cur[e];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int apsp_fused_launch(const float* d, float* out, int batch, int n,
                                 int n_iters, void* stream) {
  const size_t smem = 2 * (size_t)n * n * sizeof(float);  // the two panes
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        apsp_fused, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  apsp_fused<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      d, out, n, n_iters);
  return (int)cudaGetLastError();
}

extern "C" const char* apsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def _src_path():
    sys.path.insert(0, os.path.join(ROOT, "src"))


def variant_source(name: str) -> str:
    """The CUDA source of one variant."""
    if name == "first":
        return FIRST_SOURCE
    _src_path()
    from repro_torch.kernels import build

    text = (build.CSRC / "apsp.cu").read_text()
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
    cu = out_dir / f"apsp_{name}.cu"
    cu.write_text(variant_source(name))
    so = out_dir / f"libapsp_{name}.so"
    proc = subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                             str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, so


def finish_build(handle) -> tuple[ctypes.CDLL, str]:
    """Wait for one variant's nvcc; returns (library, nvcc/ptxas log).
    Raises if the build failed."""
    from repro_torch.kernels import apsp as ap

    name, proc, so = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
    lib = ctypes.CDLL(str(so))
    for fn in ("apsp_fused_launch", "apsp_error_string"):
        restype, argtypes = ap._SIGNATURES[fn]
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib, log


def run(lib, d, n_iters: int):
    """One launch of a variant on the current stream (the operand as
    ``apsp_fused_cuda`` takes it); returns the costs."""
    import torch

    B, n, _ = d.shape
    out = torch.empty_like(d)
    stream = torch.cuda.current_stream(d.device)
    rc = lib.apsp_fused_launch(d.data_ptr(), out.data_ptr(), B, n, n_iters,
                               stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"variant launch failed: "
                           f"{lib.apsp_error_string(rc).decode()}")
    return out


def routing_operand(dev):
    """The fused APSP's operand on the device-routing path, as
    ``chip_smoke.py`` phase 11 times it: the hop costs of every registry
    topology at 64 chiplets that relays everywhere, clamped (BIG = no
    edge, zero diagonal)."""
    import torch

    from repro_torch.core.graph import build_graph
    from repro_torch.kernels.ops import apsp
    from repro_torch.kernels.ref import BIG
    from repro_torch.routing.tables import _edge_costs
    from repro_torch.topologies import TOPOLOGIES, make_design

    graphs = [build_graph(make_design(t, 64)) for t in TOPOLOGIES
              if t != "custom"]
    costs = np.stack([_edge_costs(g, "hops") for g in graphs
                      if g.relay.all() and g.n == 64])
    d = apsp(torch.from_numpy(costs).to(dev), 0)
    return torch.where(torch.isinf(d), BIG, d).contiguous()


def squarings_to_fixed_point(d, n_iters: int) -> list[int]:
    """Per design: the squarings after which the next one changes nothing
    (plain version, one squaring at a time), capped at n_iters."""
    import torch

    from repro_torch.kernels.apsp import apsp_plain

    out = []
    for i in range(d.shape[0]):
        m = d[i:i + 1]
        for s in range(n_iters + 1):
            nxt = apsp_plain(m, 1)
            if s == n_iters or torch.equal(nxt, m):
                out.append(s)
                break
            m = nxt
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, ROOT)
    from chip_smoke import (ProfilerMiss, kernel_device_ms, ptxas_report,
                            random_costs)

    _src_path()
    from repro_torch.kernels.apsp import apsp_plain
    from repro_torch.kernels.ops import apsp_iters
    from repro_torch.kernels.ref import BIG

    handles = [start_build(name) for name in VARIANTS]
    libs, ptxas = {}, {}
    for handle in handles:
        name = handle[0]
        libs[name], log = finish_build(handle)
        ptxas[name] = ptxas_report({name: log})
        print(f"{name}: {ptxas[name]}", flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    d64 = routing_operand(dev)
    operands = [torch.from_numpy(random_costs(rng, 8, n, BIG)).to(dev)
                for n in CHECK_NS] + [d64]
    for d in operands:
        it = apsp_iters(d.shape[-1])
        want = apsp_plain(d, it)
        for name in VARIANTS:
            if not torch.equal(run(libs[name], d, it), want):
                sys.exit(f"{name}: differs from plain at {tuple(d.shape)}")

    it64 = apsp_iters(d64.shape[-1])
    fixed = squarings_to_fixed_point(d64, it64)
    print(f"squarings to the fixed point at {tuple(d64.shape)}: {fixed}",
          flush=True)

    def time_ms(name, reps=30):
        for _ in range(3):
            run(libs[name], d64, it64)
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run(libs[name], d64, it64)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def device_ms(name, tries=3):
        """The profiler's device time of one call (a session that recorded
        no launch is run again)."""
        call = lambda: run(libs[name], d64, it64)
        for _ in range(tries - 1):
            try:
                return kernel_device_ms(torch, call, "apsp_fused", 1)
            except ProfilerMiss as e:
                print(f"{name}: {e}; again", flush=True)
        return kernel_device_ms(torch, call, "apsp_fused", 1)

    # the call in order and in reverse; the device time (steady) once
    times = {name: [] for name in VARIANTS}
    device = {}
    for name in VARIANTS + VARIANTS[::-1]:
        times[name].append(time_ms(name))
        if name not in device:
            device[name] = device_ms(name)
        print(f"{name}: {times[name][-1]:.5f} ms (device "
              f"{device[name]:.5f})", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"shape": list(d64.shape), "n_iters": it64,
                      "squarings_to_fixed_point": fixed, "ptxas": ptxas,
                      "ms": times, "device_ms": device,
                      "bit_equal_to_plain_and_first": True}))
    print(card)


if __name__ == "__main__":
    main()
