#!/usr/bin/env python3
"""Time the load-propagation kernel pair (B1/B2) against variants that each
undo one step of its design, on one NVIDIA Hopper GPU.

    python3 tools/load_prop_steps.py

Variants, each built with the port's nvcc flags into
``build/repro_torch/variants/``:

* ``design`` — ``src/repro_torch/kernels/csrc/load_prop.cu`` as it is (8
  rows a CTA, one warp a row, warp-ranked predecessor lists, the flow one
  warp a source row);
* ``rows4`` — the same library launched with 4 rows a CTA in both kernels;
* ``smem_state`` — each lane's list ranges, L and W stay in shared memory
  at every n (``hop_vpl`` 0), as the design keeps them only above 256;
* ``match_lists`` — the hop kernel ranks peers with ``__match_any_sync``
  and counts from the groups, as the flow kernel does, in place of ballots
  and integer atomics;
* ``ballot_flow`` — the flow kernel ranks peers with ballots and counts
  with integer atomics, as the hop kernel does;
* ``serial_lists`` — each warp's lane 0 builds its row's lists alone (a
  serial stable counting sort over the staged row) in place of the warp's
  inversion;
* ``serial_flow`` — the flow kernel of the first design (one thread per
  source row walks all n destinations into a shared-memory row) under the
  design's hop kernel;
* ``first`` — the first design, kept here as ``FIRST_SOURCE``: one CTA per
  (design, slab of destination rows that fit in 48 KB), lists built by one
  thread per row from strided global loads, one thread per element a hop
  with a block-wide barrier, one thread per source row in the flow.

Every variant sums each L'[d, v] over v's predecessors in ascending u and
each flow[u, v] in ascending d, so W and flow are checked bit-equal to
``first``'s on random tables with unreachable pairs and padded vertices
(n in {16, 100, 128, 160, 256}) and on the timed operands. Each is timed
with CUDA events at the README sweep's second chunk ([60, 128, 128], 12
hops) and the large-n tier ([8, 256, 256], 30 hops), in the variants'
order and then in reverse: the call between two CUDA events (``ms``);
once, the profiler's device time of both kernels (``device``); ``design`` also
at 0 hops (``zero_hops``: the staging, the inversion and the stores
alone). Prints each variant's ptxas lines and times, then one JSON object
and the card's name and power limit.

``chip_smoke.py`` builds ``first`` beside the port's sources and holds the
kernel's W and flow bit-equal to it.
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
CHECK_NS = (16, 100, 128, 160, 256)
INVERT = ("__device__ void warp_invert(const uint16_t* key, int n, "
          "uint32_t* rng,\n                            uint16_t* lst, "
          "int lane) {\n")
SERIAL_INVERT = """__device__ void warp_invert(const uint16_t* key, int n, uint32_t* rng,
                            uint16_t* lst, int lane) {
  if (lane == 0) {
    for (int v = 0; v < n; ++v) rng[v] = 0;
    for (int i = 0; i < n; ++i)
      if (key[i] < n) ++rng[key[i]];
    unsigned end = 0;
    for (int v = 0; v < n; ++v) {
      end += rng[v] & 0xffffu;
      rng[v] = end | (end << 16);
    }
    for (int i = n - 1; i >= 0; --i)
      if (key[i] < n) lst[--rng[key[i]] & 0xffffu] = (uint16_t)i;
  }
  __syncwarp();
}

template <bool FEW>
__device__ void warp_invert_parallel(const uint16_t* key, int n,
                                     uint32_t* rng, uint16_t* lst, int lane) {
"""
FLOW_START = "__global__ void __launch_bounds__(kWarps * 32)\nload_prop_flow("
FLOW_END = "// The hop kernel's values a lane at n"
EDITS = {
    "design": [],
    "rows4": [],
    "smem_state": [("  return vpl <= 8 ? vpl : 0;\n", "  return 0;\n")],
    "match_lists": [("  warp_invert<false>(reinterpret_cast",
                     "  warp_invert<true>(reinterpret_cast")],
    "ballot_flow": [("  warp_invert<true>(key", "  warp_invert<false>(key")],
    "serial_lists": [(INVERT, SERIAL_INVERT)],
}
VARIANTS = ("design", "rows4", "smem_state", "match_lists", "ballot_flow",
            "serial_lists", "serial_flow", "first")

FIRST_SOURCE = r"""// Per-destination load propagation on Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels src/repro/kernels/load_prop.py:144
// (_load_prop_kernel, the fused whole-pane form) and :279
// (_load_prop_tiled_kernel, the destination-tiled form). One slab kernel
// serves every n.
//
// What it computes, per design b (nh src-major: nh[u, d] is u's next hop
// toward d; L dest-major: L[d, u] is load at u bound for d):
//   hop:   L'[d, v] = sum_u [nh[u, d] == v] * L[d, u],   L'[d, d] = 0
//   W      = sum_{j < max_hops} L_j
//   flow[u, v] = sum_d [nh[u, d] == v] * W[d, u]
//
// What bounds it on the H100: the bytes of nh, load0, W and flow, 16 B n^2
// per design, moved once. The work is about 2 n^2 float adds per hop per
// design, and the hop count is the routed diameter (tens of hops), so the
// arithmetic is small beside the bytes but is latency bound: every hop
// depends on the previous one, and each destination row is a data-dependent
// scatter.
//
// What the design does about it:
// * load_prop_hops: one CTA per (design, slab of `tile` destination rows);
//   the slab's L, L' and W live in shared memory for all hops, so device
//   memory sees nh and load0 read once and W written once. `tile` depends on
//   n only (never on the batch), so a design gives the same bits alone or in
//   a batch.
// * The scatter becomes a gather without atomics: each row's table column
//   nh[:, d] is inverted once into predecessor lists (a stable counting sort,
//   one thread per row), and every hop sums L'[d, v] over v's predecessors in
//   ascending u. The order is fixed, so the result is deterministic.
// * A slab stops once its whole L is zero (the remaining hops would add
//   exact zeros). Unreachable pairs self-loop (nh[u, d] == u) and keep their
//   load, so such a slab runs all max_hops hops, as the reference does.
// * load_prop_flow: the flow contraction crosses slabs, so it is a second
//   kernel that reads the finished W: one thread per source row u walks d in
//   ascending order and accumulates into a shared-memory row. No atomics.
// * Table entries outside [0, n) contribute nothing (the reference's one-hot
//   of such an index is all zero).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHopThreads = 256;
constexpr int kFlowThreads = 128;
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kHopThreads)
load_prop_hops(const int* __restrict__ nh, const float* __restrict__ load0,
               float* __restrict__ w_out, int n, int tile, int n_tiles,
               int max_hops) {
  const int b = blockIdx.x / n_tiles;
  const int d0 = (blockIdx.x % n_tiles) * tile;
  const int rows = min(tile, n - d0);
  const int elems = rows * n;
  const size_t base = (size_t)b * n * n;
  const size_t slab = base + (size_t)d0 * n;

  extern __shared__ __align__(16) unsigned char smem[];
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + (size_t)tile * n;
  float* acc = nxt + (size_t)tile * n;
  uint16_t* off = reinterpret_cast<uint16_t*>(acc + (size_t)tile * n);
  uint16_t* pred = off + (size_t)tile * (n + 1);

  // Predecessor lists of each destination row d: u with nh[u, d] == v sit
  // in pred[off[v] .. off[v+1]) in ascending u.
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int d = d0 + t;
    uint16_t* o = off + (size_t)t * (n + 1);
    uint16_t* p = pred + (size_t)t * n;
    for (int v = 0; v < n; ++v) o[v] = 0;
    for (int u = 0; u < n; ++u) {
      const unsigned v = (unsigned)nh[base + (size_t)u * n + d];
      if (v < (unsigned)n) ++o[v];
    }
    for (int v = 1; v < n; ++v) o[v] += o[v - 1];
    o[n] = o[n - 1];
    for (int u = n - 1; u >= 0; --u) {
      const unsigned v = (unsigned)nh[base + (size_t)u * n + d];
      if (v < (unsigned)n) p[--o[v]] = (uint16_t)u;
    }
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int t = e / n;
    cur[e] = (d0 + t != e - t * n) ? load0[slab + e] : 0.f;
    acc[e] = 0.f;
  }
  __syncthreads();

  for (int hop = 0; hop < max_hops; ++hop) {
    int live = 0;
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int t = e / n;
      const int v = e - t * n;
      acc[e] += cur[e];
      float s = 0.f;
      if (d0 + t != v) {
        const uint16_t* o = off + (size_t)t * (n + 1);
        const uint16_t* p = pred + (size_t)t * n;
        const float* row = cur + (size_t)t * n;
        const int k1 = o[v + 1];
        for (int k = o[v]; k < k1; ++k) s += row[p[k]];
      }
      nxt[e] = s;
      live |= (s != 0.f);
    }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    // barrier + block-wide OR: the slab stops once no load is left
    if (!__syncthreads_or(live)) break;
  }
  for (int e = threadIdx.x; e < elems; e += blockDim.x) w_out[slab + e] = acc[e];
}

__global__ void __launch_bounds__(kFlowThreads)
load_prop_flow(const int* __restrict__ nh, const float* __restrict__ w,
               float* __restrict__ flow, int n, int rows_per_block,
               int n_blocks) {
  const int b = blockIdx.x / n_blocks;
  const int u0 = (blockIdx.x % n_blocks) * rows_per_block;
  const int rows = min(rows_per_block, n - u0);
  const int elems = rows * n;
  const size_t base = (size_t)b * n * n;

  extern __shared__ __align__(16) unsigned char smem[];
  float* f = reinterpret_cast<float*>(smem);
  for (int e = threadIdx.x; e < elems; e += blockDim.x) f[e] = 0.f;
  __syncthreads();
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    const int u = u0 + t;
    const int* nh_row = nh + base + (size_t)u * n;
    float* f_row = f + (size_t)t * n;
    for (int d = 0; d < n; ++d) {
      const unsigned v = (unsigned)nh_row[d];
      if (v < (unsigned)n) f_row[v] += w[base + (size_t)d * n + u];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < elems; e += blockDim.x)
    flow[base + (size_t)u0 * n + e] = f[e];
}

size_t hops_smem_bytes(int n, int tile) {
  return (size_t)tile * n * 3 * sizeof(float) +
         (size_t)tile * (n + 1) * sizeof(uint16_t) +
         (size_t)tile * n * sizeof(uint16_t);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" size_t load_prop_hops_smem(int n, int tile) {
  return hops_smem_bytes(n, tile);
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int load_prop_launch(const int* nh, const float* load0, float* w,
                                float* flow, int batch, int n, int max_hops,
                                int tile, int flow_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + tile - 1) / tile;
  const size_t smem1 = hops_smem_bytes(n, tile);
  const int elems = tile * n;
  const int threads1 = elems >= kHopThreads ? kHopThreads : ((elems + 31) / 32) * 32;
  cudaError_t err = allow_smem(load_prop_hops, smem1);
  if (err != cudaSuccess) return (int)err;
  load_prop_hops<<<batch * n_tiles, threads1, smem1, s>>>(nh, load0, w, n, tile,
                                                          n_tiles, max_hops);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_blocks = (n + flow_rows - 1) / flow_rows;
  const size_t smem2 = (size_t)flow_rows * n * sizeof(float);
  err = allow_smem(load_prop_flow, smem2);
  if (err != cudaSuccess) return (int)err;
  load_prop_flow<<<batch * n_blocks, kFlowThreads, smem2, s>>>(nh, w, flow, n,
                                                               flow_rows, n_blocks);
  return (int)cudaGetLastError();
}

extern "C" const char* load_prop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
"""


def _src_path():
    sys.path.insert(0, os.path.join(ROOT, "src"))


def _first_flow() -> str:
    """The first design's flow kernel, under the design's block size."""
    text = FIRST_SOURCE[FIRST_SOURCE.index(
        "__global__ void __launch_bounds__(kFlowThreads)\nload_prop_flow("):]
    text = text[:text.index("size_t hops_smem_bytes")]
    return text.replace("__launch_bounds__(kFlowThreads)",
                        "__launch_bounds__(kWarps * 32)")


def variant_source(name: str) -> str:
    """The CUDA source of one variant."""
    if name == "first":
        return FIRST_SOURCE
    _src_path()
    from repro_torch.kernels import build

    text = (build.CSRC / "load_prop.cu").read_text()
    if name == "serial_flow":
        i, j = text.index(FLOW_START), text.index(FLOW_END)
        return text[:i] + _first_flow() + text[j:]
    for old, new in EDITS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the line to change is not in the "
                               f"source: {old}")
        text = text.replace(old, new)
    return text


def plan(name: str, n: int) -> tuple[int, int]:
    """(destination rows a hop CTA, source rows a flow CTA) of a variant;
    ``first`` keeps its own rule (as many rows as fit in 48 KB, at most
    32)."""
    if name == "first":
        return (max(1, min(32, n, 48 * 1024 // (16 * n + 2))),
                max(1, min(32, n, 48 * 1024 // (4 * n))))
    if name == "rows4":
        return min(4, n), min(4, n)
    _src_path()
    from repro_torch.kernels import load_prop as lp

    return lp.cuda_tile(n), lp.cuda_flow_rows(n)


def start_build(name: str):
    """Start nvcc for one variant; returns a handle for ``finish_build``.
    ``design`` and ``rows4`` share one library."""
    _src_path()
    from repro_torch.kernels import build

    lib_name = "design" if name == "rows4" else name
    out_dir = build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"load_prop_{lib_name}.cu"
    cu.write_text(variant_source(name))
    so = out_dir / f"libload_prop_{lib_name}.{name}.so"
    proc = subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                             str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, so


def finish_build(handle) -> tuple[ctypes.CDLL, str]:
    """Wait for one variant's nvcc; returns (library, nvcc/ptxas log).
    Raises if the build failed."""
    from repro_torch.kernels import load_prop as lp

    name, proc, so = handle
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
    lib = ctypes.CDLL(str(so))
    for fn in ("load_prop_launch", "load_prop_error_string"):
        restype, argtypes = lp._SIGNATURES[fn]
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib, log


def run(lib, name: str, next_hop, load0, max_hops: int):
    """One call of a variant's kernel pair on the current stream (operands
    as ``load_prop_cuda`` takes them); returns (W, flow)."""
    import torch

    B, n, _ = next_hop.shape
    w = torch.empty_like(load0)
    flow = torch.empty_like(load0)
    tile, rows = plan(name, n)
    stream = torch.cuda.current_stream(next_hop.device)
    rc = lib.load_prop_launch(next_hop.data_ptr(), load0.data_ptr(),
                              w.data_ptr(), flow.data_ptr(), B, n, max_hops,
                              tile, rows, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed: "
                           f"{lib.load_prop_error_string(rc).decode()}")
    return w, flow


def sweep_operands(dev):
    """(next_hop, load0, max_hops) of the README sweep's second chunk and of
    the large-n tier, as ``chip_smoke.py`` phase 6 times them."""
    import dataclasses

    import torch

    from repro_torch.core.throughput import _dest_major_load0
    from repro_torch.dse import (ExperimentSpec, encode_designs,
                                 expand_experiments)

    sys.path.insert(0, ROOT)
    from chip_smoke import SWEEP_TOPOLOGIES

    points = expand_experiments(ExperimentSpec(
        topologies=SWEEP_TOPOLOGIES, chiplet_counts=(16, 36, 64),
        traffic_patterns=("random_uniform", "hotspot"),
        routings=("dijkstra_lowest_id", "updown_random")))
    big = expand_experiments(ExperimentSpec(
        topologies=("mesh", "torus", "hexamesh"), chiplet_counts=(256,),
        traffic_patterns=("random_uniform", "hotspot")))
    big += expand_experiments(ExperimentSpec(
        topologies=("kite",), chiplet_counts=(100,),
        traffic_patterns=("random_uniform", "hotspot")))
    big = [dataclasses.replace(p, index=i) for i, p in enumerate(big)]
    out = {}
    for key, pts in (("sweep", points[60:120]), ("large_n", big)):
        b = encode_designs(pts, validate=False, device=dev)
        nh = b.next_hop.to(torch.int32).contiguous()
        out[key] = (nh, _dest_major_load0(nh, b.traffic).contiguous(),
                    b.max_hops)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, ROOT)
    from chip_smoke import (LOAD_PROP_KERNELS, ProfilerMiss, call_device_ms,
                            ptxas_report, random_routing)

    handles = [start_build(name) for name in VARIANTS]
    libs, ptxas = {}, {}
    for handle in handles:
        name = handle[0]
        libs[name], log = finish_build(handle)
        ptxas[name] = ptxas_report({name: log})
        print(f"{name}: {ptxas[name]}", flush=True)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2023)
    gpu = lambda x: torch.from_numpy(x).to(dev)
    checks = [(gpu(nh), gpu(l0), n + 2) for n in CHECK_NS
              for nh, l0 in [random_routing(rng, 3, n, n - n // 10)]]
    shapes = sweep_operands(dev)
    for nh, l0, hops in checks + list(shapes.values()):
        want = run(libs["first"], "first", nh, l0, hops)
        for name in VARIANTS:
            got = run(libs[name], name, nh, l0, hops)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                sys.exit(f"{name}: W or flow differs from first's at "
                         f"{tuple(nh.shape)}")

    def time_ms(name, operands, reps=20):
        call = lambda: run(libs[name], name, *operands)
        for _ in range(3):
            call()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    def device_ms(name, nh, l0, hops, tries=3):
        """The profiler's device time of one call (a session that recorded
        no launch is run again)."""
        for _ in range(tries - 1):
            try:
                return call_device_ms(torch, lambda: run(libs[name], name, nh,
                                                         l0, hops),
                                      LOAD_PROP_KERNELS)
            except ProfilerMiss as e:
                print(f"{name}: {e}; again", flush=True)
        return call_device_ms(torch, lambda: run(libs[name], name, nh, l0,
                                                 hops), LOAD_PROP_KERNELS)

    # the call in order and in reverse; the device time (steady) once
    times = {key: {name: [] for name in VARIANTS} for key in shapes}
    device = {key: {} for key in shapes}
    for name in VARIANTS + VARIANTS[::-1]:
        for key, operands in shapes.items():
            times[key][name].append(time_ms(name, operands))
            if name not in device[key]:
                device[key][name] = device_ms(name, *operands)
        print(f"{name}: " + ", ".join(
            f"{k} {times[k][name][-1]:.5f} ms (device "
            f"{device[k][name]['device_ms']:.5f})" for k in shapes),
            flush=True)
    zero_hops = {key: device_ms("design", nh, l0, 0)
                 for key, (nh, l0, _) in shapes.items()}
    print(f"design at 0 hops: {zero_hops}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"shapes": {k: [list(v[0].shape), v[2]]
                                 for k, v in shapes.items()},
                      "ptxas": ptxas, "ms": times, "device": device,
                      "zero_hops": zero_hops,
                      "bit_equal_to_first": True}))
    print(card)


if __name__ == "__main__":
    main()
