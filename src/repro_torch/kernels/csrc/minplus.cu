// Batched (min, +) matrix product on Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/minplus.py:31 (_minplus_kernel).
// The same kernel body also replaces src/repro/kernels/apsp.py:167
// (_apsp_square_kernel, one blocked min-plus squaring): that kernel is this
// product applied to (m, m), launched once per squaring by
// kernels/apsp.py:apsp_square_cuda, as the load-propagation slab kernel
// serves both B1 and B2.
//
// What it computes, per design b:
//   out[i, j] = min(BIG, min_k a[i, k] + b[k, j])
// The accumulator starts at BIG (1e18, "no edge"), as the TPU kernel's
// scratch does. Every candidate is one f32 add and min is exact in any
// order, so the result is bit-equal to the plain broadcast whatever the k
// order or tiling. NaN inputs are outside the contract (fminf drops them).
//
// What bounds it on the H100: the operations. Each (i, k, j) candidate is
// one FADD and one FMNMX; add and min do not fuse into one float
// instruction, so the floor is 2 B M K N instructions over 132 SMs x 128
// FP32 lanes x the SM clock. The bytes (a, b and out, 4 B (MK + KN + MN)
// per design) are far smaller at the shapes the port uses. Tensor cores
// cannot evaluate (min, +).
//
// What the design does about it:
// * one CTA per (design, 64 x 64 output tile); the k loop stages 16-deep
//   slices of a (transposed) and b through shared memory;
// * 256 threads, each keeping a 4 x 4 block of the accumulator in
//   registers: 8 shared-memory loads feed 16 candidates, so the FP32 pipes
//   and not shared memory are the limit;
// * ragged edges are masked in the kernel: a row or column beyond the
//   matrix loads BIG (BIG + BIG never wins), and is not stored. The wrapper
//   does not pad;
// * no atomics and no tiling that depends on the batch: a design gives the
//   same bits alone or in a batch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output rows and columns per CTA
constexpr int kDepth = 16;     // k per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr float kBig = 1e18f;

__global__ void __launch_bounds__(kThreads)
minplus_tiled(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int M, int K, int N, int tiles_m,
              int tiles_n) {
  const int tiles = tiles_m * tiles_n;
  const int design = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int m0 = (t / tiles_n) * kTile;
  const int n0 = (t % tiles_n) * kTile;
  const float* A = a + (size_t)design * M * K;
  const float* B = b + (size_t)design * K * N;
  float* O = out + (size_t)design * M * N;

  // as[k][row] (+1 column against bank conflicts on the transposed store)
  __shared__ float as[kDepth][kTile + 1];
  __shared__ float bs[kDepth][kTile];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = kBig;

  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int e = threadIdx.x; e < kTile * kDepth; e += kThreads) {
      const int r = e / kDepth, ka = e % kDepth;      // a: along k
      const int gr = m0 + r, gka = k0 + ka;
      as[ka][r] = (gr < M && gka < K) ? A[(size_t)gr * K + gka] : kBig;
      const int kb = e / kTile, c = e % kTile;        // b: along columns
      const int gkb = k0 + kb, gc = n0 + c;
      bs[kb][c] = (gkb < K && gc < N) ? B[(size_t)gkb * N + gc] : kBig;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float ra[4], rb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) rb[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fminf(acc[i][j], ra[i] + rb[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) O[(size_t)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = ok). `a` and `b`
// may be the same buffer (a squaring); `out` must not overlap either.
extern "C" int minplus_launch(const float* a, const float* b, float* out,
                              int batch, int M, int K, int N, void* stream) {
  const int tiles_m = (M + kTile - 1) / kTile;
  const int tiles_n = (N + kTile - 1) / kTile;
  const long long blocks = (long long)batch * tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  minplus_tiled<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, b, out, M, K, N,
                                                       tiles_m, tiles_n);
  return (int)cudaGetLastError();
}

extern "C" const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
