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
// docstring adds in scheduling order and is not deterministic. At one design
// the four launches below, not the bytes, set the time.
//
// What the design does about it: a stable counting sort of the pairs by row
// (cur), then one warp per row that adds the row's pairs in ascending p, so
// the work is O(P + n^2) per design, not the O(P n / 32) of a scan of every
// pair by every row. Four kernels, all launched by flow_accum_launch:
// 1. fa_hist: per (design, chunk of `chunk` pairs) a row histogram in shared
//    memory (integer atomics, exact in any order), written as counts
//    [B, n, n_chunks] (row-major over (row, chunk)).
// 2. fa_scan: per design one block turns the counts into exclusive offsets
//    in place, 8192 at a time, and writes the number of pairs after them,
//    so row r's sorted segment is [off[r, 0], off[r + 1, 0]).
// 3. fa_scatter: one warp per (design, chunk) loads its chunk 512 pairs at a
//    time into registers and takes them 32 at a time in ascending p; __match_any_sync on the row and a popc of the lower
//    lanes give each pair its rank among the earlier pairs of its row, so the
//    sort keeps p order inside every row. It writes the pair's nxt and amount
//    to its slot.
// 4. fa_walk: one warp per (design, row) keeps the row of out in shared
//    memory, starting from flow, and walks the row's segment 32 pairs at a
//    time; in each group the lowest lane of every column adds that column's
//    pairs in lane (= p) order. Only one lane writes a cell at a time, so the
//    adds to a cell happen in ascending p with no float atomics, whatever
//    the batch.
// A pair whose cur or nxt lies outside [0, n) is dropped by 1 and 3 alike.
// Shared memory: fa_walk holds kWalkWarps x (n + 32) floats, 16 (n + 32)
// bytes (4.6 KB at n = 256, 28 KB at n = 1720); fa_hist and fa_scatter n
// ints. Scratch (allocated by the wrapper, not here): B (n n_chunks + 1)
// offsets and B P sorted (nxt, amount) pairs.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHistThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;       // counts a thread scans at once
constexpr int kScanTile = kScanThreads * kScanPer;
constexpr int kWalkWarps = 4;   // rows per fa_walk block, one a warp
constexpr int kScatterTile = 16;  // groups of 32 pairs a lane loads at once

__device__ __forceinline__ bool pair_live(int u, int v, int n) {
  return (unsigned)u < (unsigned)n && (unsigned)v < (unsigned)n;
}

__global__ void __launch_bounds__(kHistThreads)
fa_hist(const int* __restrict__ cur, const int* __restrict__ nxt,
        int* __restrict__ counts, int n, int P, int chunk, int n_chunks) {
  extern __shared__ int hist[];                        // [n]
  const int c = blockIdx.x % n_chunks;
  const int b = blockIdx.x / n_chunks;
  for (int r = threadIdx.x; r < n; r += kHistThreads) hist[r] = 0;
  __syncthreads();
  const int p0 = c * chunk, p1 = min(P, p0 + chunk);
  const int* C = cur + (size_t)b * P;
  const int* X = nxt + (size_t)b * P;
  for (int p = p0 + threadIdx.x; p < p1; p += kHistThreads) {
    const int u = C[p];
    if (pair_live(u, X[p], n)) atomicAdd(&hist[u], 1);
  }
  __syncthreads();
  int* out = counts + (size_t)b * ((size_t)n * n_chunks + 1);
  for (int r = threadIdx.x; r < n; r += kHistThreads)
    out[(size_t)r * n_chunks + c] = hist[r];
}

// Exclusive scan of one design's L = n * n_chunks counts, in place; the
// total goes to slot L. The block takes kScanTile counts at a time through
// shared memory (coalesced loads and stores; one pad word every 32 keeps a
// thread's run of kScanPer off its neighbours' banks): each thread sums its
// run, the block scans the run totals, and each thread writes its offsets.
__global__ void __launch_bounds__(kScanThreads)
fa_scan(int* __restrict__ counts, int L) {
  __shared__ int tile[kScanTile + kScanTile / 32];
  __shared__ int warp_sums[kScanThreads / 32];
  int* v = counts + (size_t)blockIdx.x * ((size_t)L + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto pad = [](int i) { return i + (i >> 5); };
  int carry = 0;
  for (int base = 0; base < L; base += kScanTile) {
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = k * kScanThreads + tid;
      tile[pad(i)] = base + i < L ? v[base + i] : 0;
    }
    __syncthreads();
    int r[kScanPer];
    int run = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      r[k] = tile[pad(tid * kScanPer + k)];
      run += r[k];
    }
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += up;
      }
      warp_sums[lane] = w;                             // inclusive
    }
    __syncthreads();
    int off = carry + incl - run + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      tile[pad(tid * kScanPer + k)] = off;
      off += r[k];
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = k * kScanThreads + tid;
      if (base + i < L) v[base + i] = tile[pad(i)];
    }
    __syncthreads();                          // tile and warp_sums reused
  }
  if (tid == 0) v[L] = carry;
}

__global__ void __launch_bounds__(32)
fa_scatter(const int* __restrict__ cur, const int* __restrict__ nxt,
           const float* __restrict__ amount, const int* __restrict__ offsets,
           int* __restrict__ sorted_nxt, float* __restrict__ sorted_amount,
           int n, int P, int chunk, int n_chunks) {
  extern __shared__ int next_slot[];                   // [n]
  const int lane = threadIdx.x;
  const int c = blockIdx.x % n_chunks;
  const int b = blockIdx.x / n_chunks;
  const int* off = offsets + (size_t)b * ((size_t)n * n_chunks + 1);
  for (int r = lane; r < n; r += 32) next_slot[r] = off[(size_t)r * n_chunks + c];
  __syncwarp();
  const int* C = cur + (size_t)b * P;
  const int* X = nxt + (size_t)b * P;
  const float* A = amount + (size_t)b * P;
  int* SN = sorted_nxt + (size_t)b * P;
  float* SA = sorted_amount + (size_t)b * P;
  const int p1 = min(P, c * chunk + chunk);
  const unsigned lower = (1u << lane) - 1u;
  for (int q0 = c * chunk; q0 < p1; q0 += kScatterTile * 32) {
    // the tile's pairs into registers first, all loads in flight together
    int tu[kScatterTile], tv[kScatterTile];
    float ta[kScatterTile];
#pragma unroll
    for (int g = 0; g < kScatterTile; ++g) {
      const int p = q0 + g * 32 + lane;
      tu[g] = p < p1 ? C[p] : -1;
      tv[g] = p < p1 ? X[p] : -1;
      ta[g] = p < p1 ? A[p] : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kScatterTile; ++g) {
      const int u = tu[g], v = tv[g];
      const bool live = pair_live(u, v, n);
      const unsigned peers = __match_any_sync(kFull, live ? u : -1);
      const int base = live ? next_slot[u] : 0;
      __syncwarp();
      if (live) {
        if (lane == __ffs(peers) - 1) next_slot[u] = base + __popc(peers);
        const int dst = base + __popc(peers & lower);
        SN[dst] = v;
        SA[dst] = ta[g];
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kWalkWarps * 32)
fa_walk(const float* __restrict__ flow, const int* __restrict__ offsets,
        const int* __restrict__ sorted_nxt,
        const float* __restrict__ sorted_amount, float* __restrict__ out,
        int n, int P, int n_chunks, int row_blocks) {
  extern __shared__ float walk_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / row_blocks;
  const int r = (blockIdx.x % row_blocks) * kWalkWarps + warp;
  if (r >= n) return;                                  // whole warp
  float* acc = walk_smem + (size_t)warp * (n + 32);   // [n]
  float* stage = acc + n;                              // [32]
  const float* F = flow + ((size_t)b * n + r) * n;
  for (int e = lane; e < n; e += 32) acc[e] = F[e];
  const int* off = offsets + (size_t)b * ((size_t)n * n_chunks + 1);
  const int s = off[(size_t)r * n_chunks];
  const int e = off[(size_t)(r + 1) * n_chunks];       // slot L at r = n - 1
  const int* SN = sorted_nxt + (size_t)b * P;
  const float* SA = sorted_amount + (size_t)b * P;
  __syncwarp();
  // each group's (column, amount) is loaded one group ahead
  int col = s + lane < e ? SN[s + lane] : -1;
  float amt = s + lane < e ? SA[s + lane] : 0.f;
  for (int k0 = s; k0 < e; k0 += 32) {
    const int k = k0 + 32 + lane;
    const int col_next = k < e ? SN[k] : -1;
    const float amt_next = k < e ? SA[k] : 0.f;
    stage[lane] = amt;
    const unsigned peers = __match_any_sync(kFull, col);
    __syncwarp();
    if (col >= 0 && lane == __ffs(peers) - 1) {
      float sum = acc[col];
      for (unsigned m = peers; m; m &= m - 1) sum += stage[__ffs(m) - 1];
      acc[col] = sum;
    }
    __syncwarp();
    col = col_next;
    amt = amt_next;
  }
  float* O = out + ((size_t)b * n + r) * n;
  for (int i = lane; i < n; i += 32) O[i] = acc[i];
}

long long walk_smem_bytes(int n) {
  return (long long)kWalkWarps * (n + 32) * sizeof(float);
}

cudaError_t set_smem(const void* fn, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// flow, out: [B, n, n] f32 (out must not overlap flow); cur, nxt: [B, P]
// int32 (a pair outside [0, n) adds nothing); amount: [B, P] f32. scratch:
// B (n * n_chunks + 1) + 2 B P int32, n_chunks = ceil(P / chunk), chunk a
// multiple of 32. Launches the four kernels on `stream` and returns
// cudaGetLastError() (0 = ok).
extern "C" int flow_accum_launch(const float* flow, const int* cur,
                                 const int* nxt, const float* amount,
                                 float* out, int* scratch, int batch, int n,
                                 int P, int chunk, void* stream) {
  if (batch < 0 || n < 0 || P < 0 || chunk < 32 || chunk % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  const int n_chunks = P > 0 ? (P + chunk - 1) / chunk : 1;
  const long long L = (long long)n * n_chunks;
  const int row_blocks = (n + kWalkWarps - 1) / kWalkWarps;
  const long long chunk_blocks = (long long)batch * n_chunks;
  const long long walk_blocks = (long long)batch * row_blocks;
  if (L >= 0x7fffffffLL || chunk_blocks > 0x7fffffffLL ||
      walk_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  int* offsets = scratch;
  int* sorted_nxt = scratch + (size_t)batch * (L + 1);
  float* sorted_amount =
      reinterpret_cast<float*>(sorted_nxt + (size_t)batch * P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_ints = (long long)n * sizeof(int);
  cudaError_t err = set_smem((const void*)fa_hist, row_ints);
  if (err == cudaSuccess) err = set_smem((const void*)fa_scatter, row_ints);
  if (err == cudaSuccess)
    err = set_smem((const void*)fa_walk, walk_smem_bytes(n));
  if (err != cudaSuccess) return (int)err;
  fa_hist<<<(unsigned)chunk_blocks, kHistThreads, (size_t)row_ints, st>>>(
      cur, nxt, offsets, n, P, chunk, n_chunks);
  fa_scan<<<(unsigned)batch, kScanThreads, 0, st>>>(offsets, (int)L);
  fa_scatter<<<(unsigned)chunk_blocks, 32, (size_t)row_ints, st>>>(
      cur, nxt, amount, offsets, sorted_nxt, sorted_amount, n, P, chunk,
      n_chunks);
  fa_walk<<<(unsigned)walk_blocks, kWalkWarps * 32,
            (size_t)walk_smem_bytes(n), st>>>(flow, offsets, sorted_nxt,
                                              sorted_amount, out, n, P,
                                              n_chunks, row_blocks);
  return (int)cudaGetLastError();
}

extern "C" const char* flow_accum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
