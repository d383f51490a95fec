// Per-destination load propagation on Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels src/repro/kernels/load_prop.py:144
// (_load_prop_kernel, the fused whole-pane form) and :279
// (_load_prop_tiled_kernel, the destination-tiled form). One pair of kernels
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
// gather.
//
// What held the first design back (device time per call on an
// H100 80GB HBM3 at 700 W: 0.1258 ms at [60,128,128], 12 hops, of which
// 0.0890 in the hop kernel; 0.2126 ms at [8,256,256], 30 hops): its
// predecessor lists were built by one thread per destination row (23 of a
// CTA's 256 threads at n = 128, each making two passes of n strided global
// loads and a serial prefix sum); its hop loop divided e / n per element and
// ended every hop with a block-wide barrier; and the flow kernel ran one
// thread per source row, 32 of 128, each walking all n destinations
// serially.
//
// What this design does about it:
// * load_prop_hops: one CTA per (design, `tile` destination rows), one warp
//   per row. The CTA stages its rows' table columns nh[:, d0:d0+tile] once
//   as uint16. Rows are independent (L'[d, .] reads only L[d, .]), so each
//   warp runs its own hop loop with no block-wide barrier and stops once
//   its row's load is all zero (the remaining hops would add exact zeros);
//   unreachable pairs self-loop (nh[u, d] == u) and keep their load, so
//   such a row runs all max_hops hops, as the reference does.
// * The scatter becomes a gather without float atomics: a warp inverts its
//   row's column into predecessor lists. Integer shared-memory atomics
//   count each v, a warp-wide prefix sum turns the counts into ends, and a
//   pass over 32-index chunks, from the top down, places each index at its
//   group's end minus its rank among its peers (the lanes holding the same
//   v, from one ballot per bit of v). Each list comes out in ascending
//   index, as the first design's stable counting sort made it. A column
//   holds about as many distinct values as entries: there
//   __match_any_sync, whose time grows with the distinct values, is slow
//   and atomics rarely collide (tools/load_prop_steps.py times the other
//   choice as `match_lists`).
// * Each hop, the lanes take v = lane, lane + 32, ..: L'[d, v] sums v's
//   predecessors in ascending u from 0.f, and W[d, v] += L[d, v] in hop
//   order: the first design's order, so W is bit-equal to it. Up to n =
//   256 a lane keeps its values' list ranges, L[d, v] and W[d, v] in
//   registers (hop_vpl: 1, 2, 4 or 8 values a lane) and advances its sums
//   one list slot at a time, so their gathers are independent; a hop
//   touches shared memory only for the gathers and the store of L'. Above
//   256 the state stays in shared memory.
// * load_prop_flow: the flow contraction crosses rows d, so it is a second
//   kernel on the finished W: one CTA per (design, `rows` source rows), one
//   warp per source row u. The CTA stages W[:, u0:u0+rows] once; each warp
//   inverts its row nh[u, :] into per-v lists of d. A source row has few
//   distinct next hops, so here the peer groups come from __match_any_sync
//   and give the counts too (atomics would collide; `ballot_flow` in the
//   tool). flow[u, v] sums W[d,
//   u] over v's list in ascending d from 0.f, loads four ahead of the adds:
//   again the first design's order, so flow is bit-equal to it.
// * `tile` and `rows` depend on n only (kernels/load_prop.py mirrors them),
//   never on the batch, so a design gives the same bits alone or in a
//   batch. No float atomics.
// * What is left: at [60,128,128] half of the hop kernel's time goes
//   before the first hop, to the strided staging of nh's columns (32 bytes
//   a table row) and the inversion (the tool's `zero_hops`); the flow
//   kernel stages W's columns the same way.
// * Table entries outside [0, n) contribute nothing (the reference's one-hot
//   of such an index is all zero). n <= 65535 (uint16 indices).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows per CTA at most, one a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffu;       // a dropped (out-of-range) entry
constexpr size_t kDefaultSmem = 48 * 1024;

// The lanes whose v equals this lane's (every v < 2^bits). FEW: v takes
// few distinct values across the warp, where __match_any_sync is fast;
// else one ballot per bit (match_any's time grows with the distinct
// values).
template <bool FEW>
__device__ __forceinline__ unsigned peers_of(unsigned v, int bits) {
  if constexpr (FEW) return __match_any_sync(kFull, v);
  unsigned peers = kFull;
  for (int b = 0; b < bits; ++b) {
    const unsigned ones = __ballot_sync(kFull, (v >> b) & 1u);
    peers &= (v >> b) & 1u ? ones : ~ones;
  }
  return peers;
}

// Inverts key[0..n) into per-value lists: the indices i with key[i] == v
// sit in lst[rng[v] & 0xffff .. rng[v] >> 16) in ascending i; keys >= n
// are dropped. One warp; rng holds n uint32, lst n uint16. FEW: the keys
// take few distinct values (a source row's next hops), so the counts come
// from the peer groups; else (a destination column's next hops, about as
// many values as keys) from integer atomics, which then rarely collide.
template <bool FEW>
__device__ void warp_invert(const uint16_t* key, int n, uint32_t* rng,
                            uint16_t* lst, int lane) {
  for (int v = lane; v < n; v += 32) rng[v] = 0;
  __syncwarp();
  const int chunks = (n + 31) / 32;
  const int bits = 32 - __clz(n);        // v in [0, n]: n marks a dropped key
  if constexpr (FEW) {
    for (int c = 0; c < chunks; ++c) {
      const int i = c * 32 + lane;
      const unsigned v = i < n && key[i] < n ? key[i] : (unsigned)n;
      const unsigned peers = peers_of<true>(v, bits);
      if (v < (unsigned)n && __ffs(peers) - 1 == lane) rng[v] += __popc(peers);
      __syncwarp();
    }
  } else {
    for (int i = lane; i < n; i += 32)
      if (key[i] < n) atomicAdd(&rng[key[i]], 1u);
    __syncwarp();
  }
  // inclusive prefix sum of the counts: rng[v] = end | end << 16
  unsigned carry = 0;
  for (int v0 = 0; v0 < n; v0 += 32) {
    const int v = v0 + lane;
    unsigned x = v < n ? rng[v] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    x += carry;
    if (v < n) rng[v] = x | (x << 16);
    carry = __shfl_sync(kFull, x, 31);
  }
  __syncwarp();
  // placement from the top chunk down: each index at its group's end minus
  // its rank among its peers; the group's lowest lane then lowers the end
  // (the low half counts down to the start)
  const unsigned below = (1u << lane) - 1u;
  for (int c = chunks - 1; c >= 0; --c) {
    const int i = c * 32 + lane;
    const unsigned v = i < n && key[i] < n ? key[i] : (unsigned)n;
    const unsigned peers = peers_of<FEW>(v, bits);
    const bool ok = v < (unsigned)n;
    const unsigned g = __popc(peers);
    if (ok) lst[(rng[v] & 0xffffu) - g + __popc(peers & below)] = (uint16_t)i;
    __syncwarp();
    if (ok && __ffs(peers) - 1 == lane) rng[v] -= g;
    __syncwarp();
  }
}

// key[i] = src[i * stride] for i = i0, i0 + 32, .. < n, entries outside
// [0, n) as kNone.
__device__ void stage_keys(const int* __restrict__ src, int stride, int n,
                           int i0, uint16_t* key) {
  for (int i = i0; i < n; i += 32) {
    const unsigned v = (unsigned)src[(size_t)i * stride];
    key[i] = v < (unsigned)n ? (uint16_t)v : (uint16_t)kNone;
  }
}

// Shared memory of one row (either kernel): three f32 rows (hops: L, L'
// and W; flow: the staged W column and the uint16 key row), the packed list
// ranges and the list.
__host__ __device__ constexpr size_t row_smem_bytes(int n) {
  return (size_t)n * (3 * sizeof(float) + sizeof(uint32_t) + sizeof(uint16_t));
}

struct RowBufs {
  float* f;        // 3 n floats
  uint32_t* rng;   // n
  uint16_t* lst;   // n
};

// Row t's buffers in a CTA of `rows` rows (layout of row_smem_bytes).
__device__ RowBufs row_bufs(unsigned char* smem, int n, int rows, int t) {
  float* f = reinterpret_cast<float*>(smem);
  uint32_t* r = reinterpret_cast<uint32_t*>(f + (size_t)rows * 3 * n);
  uint16_t* l = reinterpret_cast<uint16_t*>(r + (size_t)rows * n);
  return {f + (size_t)t * 3 * n, r + (size_t)t * n, l + (size_t)t * n};
}

// VPL: values v a lane owns (v = lane, lane + 32, ..), whose ranges, load
// and W stay in registers across the hops; 0 keeps them in shared memory
// (n above 32 x the largest VPL).
template <int VPL>
__global__ void __launch_bounds__(kWarps * 32)
load_prop_hops(const int* __restrict__ nh, const float* __restrict__ load0,
               float* __restrict__ w_out, int n, int tile, int n_tiles,
               int max_hops) {
  const int b = blockIdx.x / n_tiles;
  const int d0 = (blockIdx.x % n_tiles) * tile;
  const int rows = min(tile, n - d0);
  const size_t base = (size_t)b * n * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  extern __shared__ __align__(16) unsigned char smem[];

  // stage the slab's columns, tile consecutive entries a table row: row
  // t's column nh[:, d0 + t] goes to t's L' buffer as uint16 (L' is first
  // written after the inversion). The block has tile x 32 threads.
  {
    const int t = threadIdx.x % tile;
    if (t < rows)
      stage_keys(nh + base + d0 + t, n, n, threadIdx.x / tile,
                 reinterpret_cast<uint16_t*>(row_bufs(smem, n, tile, t).f + n));
  }
  __syncthreads();
  if (warp >= rows) return;

  const RowBufs rb = row_bufs(smem, n, tile, warp);
  float* cur = rb.f;
  float* nxt = rb.f + n;
  const int d = d0 + warp;
  warp_invert<false>(reinterpret_cast<const uint16_t*>(nxt), n, rb.rng,
                     rb.lst, lane);
  const float* l0 = load0 + base + (size_t)d * n;
  float* w_row = w_out + base + (size_t)d * n;
  if constexpr (VPL > 0) {
    // v's range (empty for v == d and v >= n), L[d, v] and W[d, v]
    uint32_t rg[VPL];
    float mine[VPL], wv[VPL];
    int most = 0;                        // the lane's longest list
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int v = lane + 32 * j;
      const bool own = v < n && v != d;
      rg[j] = own ? rb.rng[v] : 0u;
      mine[j] = own ? l0[v] : 0.f;
      wv[j] = 0.f;
      if (v < n) cur[v] = mine[j];
      most = max(most, (int)((rg[j] >> 16) - (rg[j] & 0xffffu)));
    }
    __syncwarp();
    for (int hop = 0; hop < max_hops; ++hop) {
      // the lane's VPL sums advance together, one list slot at a time, so
      // their gathers are independent; each still adds in ascending u
      float s[VPL];
#pragma unroll
      for (int j = 0; j < VPL; ++j) s[j] = 0.f;
      for (int q = 0; q < most; ++q) {
#pragma unroll
        for (int j = 0; j < VPL; ++j) {
          const uint32_t k = (rg[j] & 0xffffu) + q;
          if (k < (rg[j] >> 16)) s[j] += cur[rb.lst[k]];
        }
      }
      bool live = false;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        wv[j] += mine[j];
        mine[j] = s[j];
        if (lane + 32 * j < n) nxt[lane + 32 * j] = s[j];
        live |= s[j] != 0.f;
      }
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      // the row stops once no load is left
      const bool more = __any_sync(kFull, live);
      __syncwarp();
      if (!more) break;
    }
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (lane + 32 * j < n) w_row[lane + 32 * j] = wv[j];
  } else {
    float* acc = rb.f + 2 * n;
    for (int v = lane; v < n; v += 32) {
      cur[v] = v != d ? l0[v] : 0.f;
      acc[v] = 0.f;
    }
    __syncwarp();
    for (int hop = 0; hop < max_hops; ++hop) {
      bool live = false;
      for (int v = lane; v < n; v += 32) {
        acc[v] += cur[v];
        float s = 0.f;
        if (v != d) {
          const uint32_t r = rb.rng[v];
          for (uint32_t k = r & 0xffffu; k < (r >> 16); ++k)
            s += cur[rb.lst[k]];
        }
        nxt[v] = s;
        live |= s != 0.f;
      }
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
      const bool more = __any_sync(kFull, live);
      __syncwarp();
      if (!more) break;
    }
    for (int v = lane; v < n; v += 32) w_row[v] = acc[v];
  }
}

__global__ void __launch_bounds__(kWarps * 32)
load_prop_flow(const int* __restrict__ nh, const float* __restrict__ w,
               float* __restrict__ flow, int n, int rows_per_block,
               int n_blocks) {
  const int b = blockIdx.x / n_blocks;
  const int u0 = (blockIdx.x % n_blocks) * rows_per_block;
  const int rows = min(rows_per_block, n - u0);
  const size_t base = (size_t)b * n * n;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  extern __shared__ __align__(16) unsigned char smem[];

  // stage W[:, u0:u0 + rows], rows consecutive entries a W row: column
  // W[:, u0 + t] goes to row t's first buffer. The block has rows_per_block
  // x 32 threads.
  {
    const int t = threadIdx.x % rows_per_block;
    if (t < rows) {
      float* col = row_bufs(smem, n, rows_per_block, t).f;
      for (int i = threadIdx.x / rows_per_block; i < n; i += 32)
        col[i] = w[base + (size_t)i * n + u0 + t];
    }
  }
  const RowBufs rb = row_bufs(smem, n, rows_per_block, warp);
  uint16_t* key = reinterpret_cast<uint16_t*>(rb.f + n);
  if (warp < rows)
    stage_keys(nh + base + (size_t)(u0 + warp) * n, 1, n, lane, key);
  __syncthreads();
  if (warp >= rows) return;

  warp_invert<true>(key, n, rb.rng, rb.lst, lane);
  float* f_row = flow + base + (size_t)(u0 + warp) * n;
  // a source row's lists are few and long (one per next hop of u), so each
  // is summed serially, its loads four at a time ahead of the adds
  for (int v = lane; v < n; v += 32) {
    const uint32_t r = rb.rng[v];
    float s = 0.f;
    uint32_t k = r & 0xffffu;
    for (; k + 4 <= (r >> 16); k += 4) {
      const float x0 = rb.f[rb.lst[k]], x1 = rb.f[rb.lst[k + 1]];
      const float x2 = rb.f[rb.lst[k + 2]], x3 = rb.f[rb.lst[k + 3]];
      s += x0;
      s += x1;
      s += x2;
      s += x3;
    }
    for (; k < (r >> 16); ++k) s += rb.f[rb.lst[k]];
    f_row[v] = s;
  }
}

// The hop kernel's values a lane at n: the least of 1, 2, 4, 8 that covers
// n in 32 lanes, else 0 (state in shared memory).
int hop_vpl(int n) {
  int vpl = 1;
  while (vpl <= 8 && 32 * vpl < n) vpl *= 2;
  return vpl <= 8 ? vpl : 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
// `tile` (destination rows a hop CTA) and `flow_rows` (source rows a flow
// CTA) are each at most kWarps; kernels/load_prop.py chooses them from n.
extern "C" int load_prop_launch(const int* nh, const float* load0, float* w,
                                float* flow, int batch, int n, int max_hops,
                                int tile, int flow_rows, void* stream) {
  if (n < 1 || n > 65535 || tile < 1 || tile > kWarps || flow_rows < 1 ||
      flow_rows > kWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + tile - 1) / tile;
  const size_t smem1 = (size_t)tile * row_smem_bytes(n);
  const int vpl = hop_vpl(n);
  cudaError_t err;
#define HOPS(VPL)                                                            \
  err = allow_smem(load_prop_hops<VPL>, smem1);                              \
  if (err != cudaSuccess) return (int)err;                                   \
  load_prop_hops<VPL><<<batch * n_tiles, tile * 32, smem1, s>>>(            \
      nh, load0, w, n, tile, n_tiles, max_hops);
  switch (vpl) {
    case 1: HOPS(1) break;
    case 2: HOPS(2) break;
    case 4: HOPS(4) break;
    case 8: HOPS(8) break;
    default: HOPS(0) break;
  }
#undef HOPS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_blocks = (n + flow_rows - 1) / flow_rows;
  const size_t smem2 = (size_t)flow_rows * row_smem_bytes(n);
  err = allow_smem(load_prop_flow, smem2);
  if (err != cudaSuccess) return (int)err;
  load_prop_flow<<<batch * n_blocks, flow_rows * 32, smem2, s>>>(
      nh, w, flow, n, flow_rows, n_blocks);
  return (int)cudaGetLastError();
}

extern "C" const char* load_prop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
