// Fused all-pairs shortest paths by min-plus squaring on Hopper (sm_90a),
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
