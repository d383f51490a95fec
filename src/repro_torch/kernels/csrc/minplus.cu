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
// order, the tiling or the split of k. NaN inputs are outside the contract
// (fminf drops them).
//
// What bounds it on the H100: the operations. Each (i, k, j) candidate is
// one FADD and one FMNMX; add and min do not fuse into one float
// instruction, so the floor is 2 B M K N instructions over 132 SMs x 128
// FP32 lanes x the SM clock. The bytes (a, b and out, 4 B (MK + KN + MN)
// per design) are far smaller at the shapes the port uses. Tensor cores
// cannot evaluate (min, +), and DPX's fused add-min (__viaddmin_s32) is
// integer-only, so it cannot give these f32 bits.
//
// What held the first design back: one CTA per (design, 64 x 64 tile) is
// 32 CTAs at the genome selection's [8,256,256] x [8,256,64] and 48 at the
// [3,256,256] squaring, on 132 SMs, and each CTA waited on its global loads
// at every 16-deep k stage (a __syncthreads pair, no overlap). What this
// design does about it:
// * k is split over the CTAs of a thread block cluster (up to 8 on one
//   output tile, MinplusPlan below): the launch doubles the split until the
//   grid has 132 CTAs or a CTA would get fewer than 16 k. Each CTA keeps its
//   partial minimum in registers; the cluster's rank-0 CTA reads the others'
//   partials from their shared memory (distributed shared memory) in rank
//   order and stores the tile. One launch, no global scratch, no atomics;
// * the output tile is 64 x 64 where M and N are both at least 64, else
//   32 x 32 (the n = 32 genome selection would mask 75% of a 64 x 64 tile);
// * a 3-stage cp.async ring of 16-deep k slices (16-byte copies where rows
//   allow), so the next slices' loads are in flight during this one's
//   candidates: one __syncthreads a slice;
// * each thread keeps a 4 x 4 block of outputs (4 adjacent columns) in
//   registers and reads a as float4 along k and b as float4 along columns:
//   8 shared loads feed 64 candidates, so the FP32 pipes are the limit;
// * ragged edges are masked in the kernel: a k beyond the matrix (or this
//   CTA's share) loads BIG (BIG + BIG never wins); rows and columns beyond
//   it are not stored. The wrapper does not pad;
// * the split may depend on the batch (it fills the card), but the bits do
//   not: a design gives the same bits alone or in a batch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kDepth = 16;      // k per stage
constexpr int kStages = 3;      // cp.async ring
constexpr int kMaxSplit = 8;    // CTAs of a cluster on one tile (portable)
constexpr int kFillCtas = 132;  // the H100's SMs
constexpr float kBig = 1e18f;

// TILE x TILE outputs, (TILE / 4)^2 threads of 4 x 4 outputs each.
template <int TILE>
struct MinplusShape {
  static constexpr int kThreads = (TILE / 4) * (TILE / 4);
  static constexpr int kApitch = kDepth + 4;  // a[row][k], float4-aligned
  static constexpr int kStageFloats = TILE * kApitch + kDepth * TILE;
  static constexpr int kSmemFloats = kStages * kStageFloats;
  static_assert(kSmemFloats >= TILE * TILE, "the merge reuses the ring");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Stage k slice [k0, k0 + kDepth) of the tile's a rows and b columns into
// `st`; entries at k >= ke are BIG, rows >= M and columns >= N are BIG too
// (never stored).
template <int TILE>
__device__ __forceinline__ void minplus_stage(
    float* st, const float* A, const float* B, int m0, int n0, int k0,
    int ke, int M, int K, int N, bool vec_a, bool vec_b) {
  using Shape = MinplusShape<TILE>;
  constexpr int P = Shape::kApitch, THR = Shape::kThreads;
  float* as = st;                           // [TILE][P]
  float* bs = st + TILE * P;                // [kDepth][TILE]
  for (int e = threadIdx.x; e < TILE * kDepth / 4; e += THR) {
    const int r = e / (kDepth / 4), c = (e % (kDepth / 4)) * 4;
    const int gr = m0 + r, gk = k0 + c;
    float* dst = as + r * P + c;
    if (vec_a && gr < M && gk + 4 <= ke) {
      cp_async16(dst, A + (size_t)gr * K + gk);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (gr < M && gk + u < ke)
          cp_async4(dst + u, A + (size_t)gr * K + gk + u);
        else
          dst[u] = kBig;
      }
    }
  }
  for (int e = threadIdx.x; e < kDepth * TILE / 4; e += THR) {
    const int kr = e / (TILE / 4), c = (e % (TILE / 4)) * 4;
    const int gk = k0 + kr, gc = n0 + c;
    float* dst = bs + kr * TILE + c;
    if (vec_b && gk < ke && gc + 4 <= N) {
      cp_async16(dst, B + (size_t)gk * N + gc);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (gk < ke && gc + u < N)
          cp_async4(dst + u, B + (size_t)gk * N + gc + u);
        else
          dst[u] = kBig;
      }
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// Grid: one cluster of `split` CTAs per (design, output tile); the CTA of
// cluster rank r takes k in [r kc, (r + 1) kc).
template <int TILE>
__global__ void __launch_bounds__(MinplusShape<TILE>::kThreads)
minplus_tiled(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int M, int K, int N, int tiles_m,
              int tiles_n, int split, int kc, int vec_a, int vec_b) {
  using Shape = MinplusShape<TILE>;
  constexpr int P = Shape::kApitch, THR = Shape::kThreads;
  __shared__ __align__(16) float smem[Shape::kSmemFloats];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / split;
  const int tiles = tiles_m * tiles_n;
  const int design = tile / tiles;
  const int t = tile % tiles;
  const int m0 = (t / tiles_n) * TILE;
  const int n0 = (t % tiles_n) * TILE;
  const float* A = a + (size_t)design * M * K;
  const float* B = b + (size_t)design * K * N;
  float* O = out + (size_t)design * M * N;
  const int kb = min(K, rank * kc), ke = min(K, kb + kc);
  const int n_slices = (ke - kb + kDepth - 1) / kDepth;
  const int tx = threadIdx.x % (TILE / 4);
  const int ty = threadIdx.x / (TILE / 4);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = kBig;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices)
      minplus_stage<TILE>(smem + s * Shape::kStageFloats, A, B, m0, n0,
                          kb + s * kDepth, ke, M, K, N, vec_a, vec_b);
    cp_async_commit();
  }
  for (int it = 0; it < n_slices; ++it) {
    cp_async_wait<kStages - 2>();     // slice `it` has landed
    __syncthreads();                  // and every thread is past slice it-1
    const int nxt = it + kStages - 1;
    if (nxt < n_slices)
      minplus_stage<TILE>(smem + (nxt % kStages) * Shape::kStageFloats, A,
                          B, m0, n0, kb + nxt * kDepth, ke, M, K, N, vec_a,
                          vec_b);
    cp_async_commit();
    const float* as = smem + (it % kStages) * Shape::kStageFloats;
    const float* bs = as + TILE * P;
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 4) {
      float4 ra[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ra[i] = *reinterpret_cast<const float4*>(as + (ty * 4 + i) * P + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 rb =
            *reinterpret_cast<const float4*>(bs + (kk + q) * TILE + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = lane_of(ra[i], q);
          acc[i][0] = fminf(acc[i][0], av + rb.x);
          acc[i][1] = fminf(acc[i][1], av + rb.y);
          acc[i][2] = fminf(acc[i][2], av + rb.z);
          acc[i][3] = fminf(acc[i][3], av + rb.w);
        }
      }
    }
  }

  if (split > 1) {
    // every CTA parks its partial in its own shared memory ([4][threads] of
    // float4); rank 0 takes the minimum over ranks 1, 2, ... in order
    cp_async_wait<0>();
    __syncthreads();                  // the ring is no longer read
    float4* red = reinterpret_cast<float4*>(smem);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[i * THR + threadIdx.x] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < split; ++r) {
        const float4* other = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = other[i * THR + threadIdx.x];
          acc[i][0] = fminf(acc[i][0], v.x);
          acc[i][1] = fminf(acc[i][1], v.y);
          acc[i][2] = fminf(acc[i][2], v.z);
          acc[i][3] = fminf(acc[i][3], v.w);
        }
      }
    }
    cluster.sync();                   // the partials stay until read
    if (rank != 0) return;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (r < M && c < N) O[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// The launch plan (mirrored by kernels/minplus.py:minplus_plan).
struct MinplusPlan {
  int tile, tiles_m, tiles_n, split, kc;
  long long ctas;
};

MinplusPlan plan(int batch, int M, int K, int N) {
  MinplusPlan p;
  p.tile = (M >= 64 && N >= 64) ? 64 : 32;
  p.tiles_m = (M + p.tile - 1) / p.tile;
  p.tiles_n = (N + p.tile - 1) / p.tile;
  const long long tiles = (long long)batch * p.tiles_m * p.tiles_n;
  p.split = 1;
  while (p.split < kMaxSplit && tiles * p.split < kFillCtas &&
         K >= 2 * p.split * kDepth)
    p.split *= 2;
  const int per = (K + p.split - 1) / p.split;
  p.kc = (per + kDepth - 1) / kDepth * kDepth;
  p.ctas = tiles * p.split;
  return p;
}

template <int TILE>
cudaError_t launch(const MinplusPlan& p, const float* a, const float* b,
                   float* out, int M, int K, int N, int vec_a, int vec_b,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.ctas);
  cfg.blockDim = dim3(MinplusShape<TILE>::kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, minplus_tiled<TILE>, a, b, out, M, K, N,
                            p.tiles_m, p.tiles_n, p.split, p.kc, vec_a,
                            vec_b);
}

}  // namespace

// Launches on `stream`; returns the launch's error code (0 = ok). `a` and
// `b` may be the same buffer (a squaring); `out` must not overlap either.
extern "C" int minplus_launch(const float* a, const float* b, float* out,
                              int batch, int M, int K, int N, void* stream) {
  const MinplusPlan p = plan(batch, M, K, N);
  if (p.ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const auto aligned = [](const void* ptr) {
    return (reinterpret_cast<std::uintptr_t>(ptr) & 15) == 0;
  };
  const int vec_a = K % 4 == 0 && aligned(a);
  const int vec_b = N % 4 == 0 && aligned(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      p.tile == 64 ? launch<64>(p, a, b, out, M, K, N, vec_a, vec_b, st)
                   : launch<32>(p, a, b, out, M, K, N, vec_a, vec_b, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
