// Flow accumulation (the pair walk's per-hop scatter) on Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flow_accum.py:28 (_flow_kernel),
// which rebuilt the scatter as a one-hot matmul on the MXU. What it computes,
// per design b:
//   out[u, v] = flow[u, v] + sum over p of amount[p] * [cur[p] = u] * [nxt[p] = v]
// with the pairs added to each cell in ascending p, so the result is
// bit-equal to a sequential scatter-add (PyTorch's index_add_ on the CPU).
//
// What bounds it on the H100: the bytes. The work is one add per pair; the
// data is flow and out (4 n^2 bytes each) and cur, nxt, amount (12 P bytes),
// 1.3 MB per design at n = 256, P = n^2. The matmul form would do P n^2
// multiply-adds per design; the atomic scatter-add named in the reference's
// docstring adds in scheduling order and is not deterministic.
//
// What the design does about it: one warp per (design, 32 rows of out), each
// lane owning one row, with the warp's rows of out accumulated in shared
// memory (32 n floats). The warp stages the pairs through shared memory 1024
// at a time (coalesced loads, all in flight together), then takes them 32 at
// a time in ascending p: a ballot finds the pairs whose cur is one of its
// rows, and for each, in lane (= p) order, the owning lane adds the amount
// into its row. Only that lane writes the row, so the adds to a cell happen
// in ascending p with no atomics, whatever the batch. Every warp still reads
// all P pairs, so the kernel is bound by that scan (P / 32 ballots per
// warp), not by the bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;     // rows of out per block (one warp), one a lane
constexpr int kStage = 1024;  // pairs staged in shared memory at once

__global__ void __launch_bounds__(kRows)
flow_accum(const float* __restrict__ flow, const int* __restrict__ cur,
           const int* __restrict__ nxt, const float* __restrict__ amount,
           float* __restrict__ out, int n, int P, int tiles) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // [kRows][n]
  int* sc = reinterpret_cast<int*>(smem + kRows * n);  // [kStage]
  int* sn = sc + kStage;
  float* sa = reinterpret_cast<float*>(sn + kStage);
  const int lane = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kRows;
  const int rows = min(kRows, n - r0);
  const float* F = flow + (size_t)b * n * n + (size_t)r0 * n;
  for (int e = lane; e < rows * n; e += kRows) acc[e] = F[e];

  const int* C = cur + (size_t)b * P;
  const int* X = nxt + (size_t)b * P;
  const float* A = amount + (size_t)b * P;
  for (int p0 = 0; p0 < P; p0 += kStage) {
    const int cnt = min(kStage, P - p0);
    __syncwarp();
    for (int k = lane; k < cnt; k += kRows) {
      sc[k] = C[p0 + k];
      sn[k] = X[p0 + k];
      sa[k] = A[p0 + k];
    }
    __syncwarp();
    for (int g = 0; g < cnt; g += kRows) {
      const int k = g + lane;
      const int local = k < cnt ? sc[k] - r0 : -1;
      const int x = k < cnt ? sn[k] : 0;
      const bool hit =
          local >= 0 && local < rows && (unsigned)x < (unsigned)n;
      unsigned mask = __ballot_sync(0xffffffffu, hit);
      while (mask) {                       // ascending lane = ascending p
        const int j = __ffs(mask) - 1;
        mask &= mask - 1;
        const int row = __shfl_sync(0xffffffffu, local, j);
        const int col = __shfl_sync(0xffffffffu, x, j);
        if (lane == row) acc[row * n + col] += sa[g + j];
      }
    }
  }
  __syncwarp();
  float* O = out + (size_t)b * n * n + (size_t)r0 * n;
  for (int e = lane; e < rows * n; e += kRows) O[e] = acc[e];
}

// Shared memory one block needs at n nodes (bytes).
long long smem_bytes(int n) {
  return (long long)kRows * n * sizeof(float) +
         3LL * kStage * sizeof(float);
}

}  // namespace

// flow, out: [B, n, n] f32 (out must not overlap flow); cur, nxt: [B, P]
// int32 (a pair outside [0, n) adds nothing); amount: [B, P] f32. Launches on
// `stream` and returns cudaGetLastError() (0 = ok).
extern "C" int flow_accum_launch(const float* flow, const int* cur,
                                 const int* nxt, const float* amount,
                                 float* out, int batch, int n, int P,
                                 void* stream) {
  const int tiles = (n + kRows - 1) / kRows;
  const long long blocks = (long long)batch * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks == 0) return 0;
  const long long smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      flow_accum, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flow_accum<<<(unsigned)blocks, kRows, (size_t)smem,
               static_cast<cudaStream_t>(stream)>>>(flow, cur, nxt, amount,
                                                    out, n, P, tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* flow_accum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
