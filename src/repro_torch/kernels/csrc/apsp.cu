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
// (kernels/apsp.py:apsp_plain) whatever the split of the work. An in-place
// Floyd-style update would sum paths in another association and is not
// used.
//
// What bounds it on the H100: the operations, B n_iters n^3 candidates of
// one FADD and one FMNMX each (add and min do not fuse), over 132 SMs x
// 128 FP32 lanes x the SM clock. The bytes are 8 B n^2 per design (d read
// once, the result written once).
//
// What held the first design back (0.03926 ms of device time at
// [13,64,64], 7 squarings, on an H100 at 700 W): one CTA per design, so the
// 13 designs kept 13 of the 132 SMs busy, each with 8 warps (2 a scheduler)
// to hide the shared-memory latency of its k loop; and it always ran all
// n_iters squarings, though a routed design's distances converge after
// about log2(diameter) + 1 of them.
//
// What this design does about it:
// * each design runs on a thread block cluster of C CTAs (cluster_size: the
//   smallest power of two >= n / 8, at most 8, so 8 at n >= 57: 104 CTAs
//   for 13 designs at n = 64). Every CTA holds the current and the next
//   iterate as two panes in its shared memory. CTA rank r computes the
//   `band` = ceil(n / C) rows it owns from its own current pane and stores
//   them straight into the next pane of every CTA of the cluster
//   (distributed shared memory; stores need no round trip), then one
//   cluster.sync a squaring makes them visible and the panes swap. A CTA
//   writes a peer's next pane only after the barrier that ends the
//   squaring which read it. One launch a call; no intermediate matrix goes
//   to device memory;
// * a design stops at its fixed point: once a squaring leaves every entry's
//   bits unchanged (each CTA stores its "changed" flag into every peer; all
//   read the same flags after the barrier), every further squaring would
//   return the same bits, so the result equals all n_iters squarings'. A
//   NaN never counts as unchanged, so it never stops a design;
// * within a CTA, each of the 256 threads keeps an MI x W block of its band
//   in registers (1 x 2 where a band has at most 512 entries, as at n = 64;
//   else 2 x 4, or 2 x 2 where 4-float rows would not fit) and reads the W
//   columns of cur[k, .] as one vector load; rows are padded to ld = n
//   rounded up to W floats so that those loads align;
// * shared memory: the two panes (n x ld floats each) and 2 x 8 flags,
//   231,264 bytes at n = MAX_FUSED_N = 170 (ld = 170), the first design's
//   231,200 plus the flags;
// * the cluster size depends on n only and the stop on the design's own
//   iterates: no atomics, nothing that depends on the batch, so a design
//   gives the same bits alone or in a batch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;            // portable cluster size
constexpr bool kStopAtFixedPoint = true;
constexpr float kBig = 1e18f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;       // a block's opt-in limit

template <int W>
struct Vec;
template <>
struct Vec<2> {
  __device__ static void get(const float* p, float (&v)[2]) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  }
  __device__ static void put(float* p, const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void get(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ static void put(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// Bits changed, or a NaN (which never counts as unchanged).
__device__ __forceinline__ bool differs(float a, float b) {
  return __float_as_uint(a) != __float_as_uint(b) || a != a;
}

// Grid: one cluster of C CTAs per design; CTA rank r owns rows
// [r band, min(n, (r + 1) band)) of each iterate. Rows are ld floats.
template <int MI, int W>
__global__ void __launch_bounds__(kThreads)
apsp_fused(const float* __restrict__ d, float* __restrict__ out, int n,
           int n_iters, int band, int ld) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t base = (size_t)(blockIdx.x / C) * n * n;
  const int r0 = min(n, rank * band);
  const int r1 = min(n, r0 + band);
  extern __shared__ __align__(16) float smem[];
  const size_t pane = (size_t)n * ld;       // floats a pane; panes 0 and 1
  int* flags = reinterpret_cast<int*>(smem + 2 * (size_t)n * ld);  // [2][8]

  if (ld == n && n % 4 == 0 && (reinterpret_cast<size_t>(d) & 15) == 0) {
    // the design is whole, aligned float4s
    const float4* src = reinterpret_cast<const float4*>(d + base);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int e = threadIdx.x; e < n * n / 4; e += kThreads) dst[e] = src[e];
  } else {                               // padded columns read BIG
    for (int e = threadIdx.x; e < n * ld; e += kThreads) {
      const int i = e / ld, j = e - i * ld;
      smem[e] = j < n ? d[base + (size_t)i * n + j] : kBig;
    }
  }
  // every CTA of the cluster runs before any peer stores into it
  cluster.sync();

  const int col_groups = ld / W;
  const int items = (r1 - r0 + MI - 1) / MI * col_groups;
  int src = 0;
  for (int it = 0; it < n_iters; ++it) {
    const float* cur = smem + src * pane;
    float* nxt = smem + (src ^ 1) * pane;
    bool changed = false;
    for (int item = threadIdx.x; item < items; item += kThreads) {
      const int rg = item / col_groups;
      const int j0 = (item - rg * col_groups) * W;
      int rows[MI];
#pragma unroll
      for (int m = 0; m < MI; ++m) rows[m] = min(r0 + rg * MI + m, r1 - 1);
      float acc[MI][W];
#pragma unroll
      for (int m = 0; m < MI; ++m) Vec<W>::get(cur + rows[m] * ld + j0, acc[m]);
      int k = 0;
      if (ld % 4 == 0) {      // a row's 4 next entries of k in one load
        for (; k + 4 <= n; k += 4) {
          float a[MI][4];
#pragma unroll
          for (int m = 0; m < MI; ++m)
            Vec<4>::get(cur + rows[m] * ld + k, a[m]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float b[W];
            Vec<W>::get(cur + (k + kk) * ld + j0, b);
#pragma unroll
            for (int m = 0; m < MI; ++m)
#pragma unroll
              for (int w = 0; w < W; ++w)
                acc[m][w] = fminf(acc[m][w], a[m][kk] + b[w]);
          }
        }
      }
      for (; k < n; ++k) {
        float b[W];
        Vec<W>::get(cur + k * ld + j0, b);
#pragma unroll
        for (int m = 0; m < MI; ++m)
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc[m][w] = fminf(acc[m][w], cur[rows[m] * ld + k] + b[w]);
      }
#pragma unroll
      for (int m = 0; m < MI; ++m) {
        const int r = r0 + rg * MI + m;
        if (r >= r1) continue;
#pragma unroll
        for (int w = 0; w < W; ++w)     // padded columns are never compared
          if (j0 + w < n) changed |= differs(acc[m][w], cur[r * ld + j0 + w]);
        // the row into every CTA's next pane (padded columns too)
        for (int q = 0; q < C; ++q)
          Vec<W>::put(cluster.map_shared_rank(nxt, q) + r * ld + j0, acc[m]);
      }
    }
    changed = __syncthreads_or(changed);
    if (threadIdx.x == 0)
      for (int q = 0; q < C; ++q)
        *cluster.map_shared_rank(flags + (it & 1) * kMaxCluster + rank, q) =
            changed;
    cluster.sync();   // every band and flag of this squaring has landed
    bool any = !kStopAtFixedPoint;
    for (int q = 0; q < C; ++q) any |= flags[(it & 1) * kMaxCluster + q] != 0;
    if (!any) break;  // the current pane holds the fixed point
    src ^= 1;
  }
  const float* res = smem + src * pane;
  for (int e = threadIdx.x; e < (r1 - r0) * n; e += kThreads) {
    const int i = r0 + e / n, j = e % n;
    out[base + (size_t)i * n + j] = res[i * ld + j];
  }
}

// CTAs of a design's cluster: the smallest power of two >= n / 8, at most 8.
int cluster_size(int n) {
  int c = 1;
  while (c < kMaxCluster && c * 8 < n) c *= 2;
  return c;
}

template <int MI, int W>
cudaError_t launch(const float* d, float* out, int batch, int n, int n_iters,
                   int cluster, int band, int ld, size_t smem,
                   cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        apsp_fused<MI, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, apsp_fused<MI, W>, d, out, n, n_iters,
                            band, ld);
}

// Shared memory of a CTA: two panes of n x ld floats and 2 x 8 flags.
size_t smem_bytes(int n, int ld) {
  return 2 * (size_t)n * ld * sizeof(float) + 2 * kMaxCluster * sizeof(int);
}

}  // namespace

// Launches on `stream`; returns the launch's error code (0 = ok).
// kernels/apsp.py:fused_plan mirrors the cluster, band, block and shared
// memory.
extern "C" int apsp_fused_launch(const float* d, float* out, int batch, int n,
                                 int n_iters, void* stream) {
  const int cluster = cluster_size(n);
  const int band = (n + cluster - 1) / cluster;
  const int ld4 = (n + 3) & ~3, ld2 = (n + 1) & ~1;
  if ((long long)batch * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (band * n <= 2 * kThreads)
    err = launch<1, 2>(d, out, batch, n, n_iters, cluster, band, ld2,
                       smem_bytes(n, ld2), s);
  else if (smem_bytes(n, ld4) <= kMaxSmem)
    err = launch<2, 4>(d, out, batch, n, n_iters, cluster, band, ld4,
                       smem_bytes(n, ld4), s);
  else
    err = launch<2, 2>(d, out, batch, n, n_iters, cluster, band, ld2,
                       smem_bytes(n, ld2), s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* apsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
