// Per-destination load propagation on Hopper (sm_90a), plain C interface.
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
