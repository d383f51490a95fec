// Mamba-1 selective scan on Hopper (sm_90a), forward and backward, plain C
// interface.
//
// Replaces the TPU kernels src/repro/kernels/selective_scan.py:38
// (_fwd_kernel, B7) and :116 (_bwd_kernel, B8), joined on the Python side by
// a torch.autograd.Function (kernels/selective_scan.py) as the reference
// joins them by a custom_vjp.
//
// What it computes, per sequence b and channel d, with the N-vector state h:
//   a_bar_t = exp(dt_t * a),  h_t = a_bar_t * h_{t-1} + (dt_t * x_t) * B_t,
//   y_t = sum_n h_t * C_t,
// and saves h at the start of every `chunk` steps (the reference's
// checkpoint layout [B, S/chunk, Di, N]). The backward pass re-runs the
// recurrence from those checkpoints and walks each chunk in reverse with the
// adjoint lam = dy_t * C_t + m, m = a_bar * lam (the reference's _bwd_kernel,
// line by line).
//
// What bounds it on the H100. Forward at the training shape (xc, dt
// [2, 2048, 8192] f32, N 16): the inputs and outputs are 414 MB, 0.124 ms
// at 3.35 TB/s; the B*S*Di*N = 537 M exps take 0.128 ms on the SFUs (16 a
// clock per SM, 132 SMs at 1.98 GHz), so the exps, just above the bytes,
// set the floor. The backward pass moves 685 MB (0.204 ms, the floor);
// one exp per state would do, and it computes two (the sub-chunk starts and
// the recomputation, whose a_bar the reverse walk reuses).
//
// What the design does about it:
// * forward: one thread per (sequence, channel) holds its N states in
//   registers and walks the whole sequence, so nothing but the kernel's
//   inputs and outputs touches HBM (the TPU kernel's VMEM-resident state).
//   Each block stages B_t and C_t for 16 steps in shared memory and loads its
//   channels' x and dt for those steps into registers first, so the loads
//   are in flight together; y_t = sum_n h*C needs no reduction across
//   threads.
// * backward: one block per (sequence, 32 channels) walks every chunk of its
//   sequence in reverse. Each channel's N states are split over N/2 lanes,
//   two states a lane (8 lanes a channel at N = 16), so a block has 16 NP
//   threads (NP = N padded to 4, 8 or 16; 256 at N = 16), eight times the
//   threads of one warp per 32 channels; m and the dA accumulator stay in
//   registers, so dA needs no reduction across blocks (the TPU revisited its
//   output across the sequential grid axis). The reference kept a chunk's
//   pre-step states in a [chunk, bd, N] scratch (2 MiB at chunk 256); here
//   each chunk is cut into sub-chunks of kSub = 16 steps. Pass 1 runs from
//   the chunk checkpoint and stores each sub-chunk's start state in a global
//   scratch (read back by the same thread, so it stays in L2), loading a
//   sub-chunk's dt and x into registers before its walk. Then each
//   sub-chunk, last first, is staged (dt, x, dy, B_t, C_t) into shared
//   memory, recomputed from its start (pre-step states in shared memory,
//   a_bar in registers) and walked in reverse, reusing a_bar: two exps per
//   state and step. h_{t-1} is never recovered by dividing by a_bar. Every
//   state update, forward and backward, is step_state, so the recomputed
//   states equal the forward's bit for bit. Shared memory per block:
//   16 (2T + 5*32 + 2NP + 2NP*T/32) floats for T threads, 60 KB at N = 16,
//   whatever the chunk.
// * dB and dC reduce over channels: a warp sums its channels' 4 values a
//   lane per step with a transposing butterfly (3-5 shuffles), each warp
//   parks its sums for the sub-chunk in shared memory, and the block adds
//   its warps in ascending order and writes one partial per (sequence,
//   block of 32 channels, step); a second kernel sums the partials over
//   blocks in ascending order. ddt and dxc are summed over the channel's
//   lanes by a butterfly and written by the block, a row of 32 channels at
//   a time. dA sums its per-sequence partials over the batch the same way.
//   No float atomics: two runs give the same bits, and a sequence gives the
//   same bits alone as in a batch.

#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 64;   // channels per forward block
constexpr int kTile = 16;         // steps staged per forward tile
constexpr int kSub = 16;          // steps per backward sub-chunk
constexpr int kSpl = 2;           // states per lane in the backward kernel
constexpr int kBwdChannels = 32;  // channels per backward block
constexpr int kSumThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// One recurrence step of one state, h <- exp(dt a) h + (dt x) b; returns
// a_bar. The forward and both backward passes use it, so the backward's
// recomputed states equal the forward's bit for bit.
__device__ __forceinline__ float step_state(float& h, float a, float dtv,
                                            float dx, float b) {
  const float ab = expf(dtv * a);
  h = fmaf(ab, h, dx * b);
  return ab;
}

// One recurrence step of a channel's states (the forward's form).
template <int NP>
__device__ __forceinline__ void advance(float (&h)[NP], const float (&av)[NP],
                                        float dtv, float xv, const float* bt,
                                        int N) {
  const float dx = dtv * xv;
#pragma unroll
  for (int n = 0; n < NP; ++n)
    if (n < N) step_state(h[n], av[n], dtv, dx, bt[n]);
}

template <int NP>
__global__ void __launch_bounds__(kFwdThreads)
ssm_fwd(const float* __restrict__ xc, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ h0,
        float* __restrict__ y, float* __restrict__ ckpt,
        float* __restrict__ ht, int S, int Di, int N, int chunk) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kFwdThreads + threadIdx.x;
  const bool live = d < Di;
  const int n_chunks = S / chunk;
  __shared__ float sb[kTile][NP];
  __shared__ float sc[kTile][NP];

  float h[NP], av[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    const bool ok = live && n < N;
    h[n] = ok ? h0[((size_t)b * Di + d) * N + n] : 0.f;
    av[n] = ok ? a[(size_t)d * N + n] : 0.f;
  }
  const float* X = xc + (size_t)b * S * Di;
  const float* T = dt + (size_t)b * S * Di;
  const float* Bm = bm + (size_t)b * S * N;
  const float* Cm = cm + (size_t)b * S * N;
  float* Y = y + (size_t)b * S * Di;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int tn = min(kTile, S - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * NP; e += kFwdThreads) {
      const int tt = e / NP, n = e % NP;
      const bool ok = tt < tn && n < N;
      sb[tt][n] = ok ? Bm[(size_t)(t0 + tt) * N + n] : 0.f;
      sc[tt][n] = ok ? Cm[(size_t)(t0 + tt) * N + n] : 0.f;
    }
    float xr[kTile], dr[kTile];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      const bool ok = live && tt < tn;
      xr[tt] = ok ? X[(size_t)(t0 + tt) * Di + d] : 0.f;
      dr[tt] = ok ? T[(size_t)(t0 + tt) * Di + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) {
      if (tt < tn && live) {
        const int t = t0 + tt;
        if (t % chunk == 0) {
          float* ck = ckpt + (((size_t)b * n_chunks + t / chunk) * Di + d) * N;
#pragma unroll
          for (int n = 0; n < NP; ++n)
            if (n < N) ck[n] = h[n];
        }
        advance<NP>(h, av, dr[tt], xr[tt], sb[tt], N);
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NP; ++n)
          if (n < N) acc += h[n] * sc[tt][n];
        Y[(size_t)t * Di + d] = acc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < N) ht[((size_t)b * Di + d) * N + n] = h[n];
  }
}

// Backward block shape for NP padded states: kSpl states a lane, NP / kSpl
// lanes a channel, kBwdChannels channels a block.
template <int NP>
struct BwdShape {
  static constexpr int kLanes = NP / kSpl;               // lanes a channel
  static constexpr int kThreads = kBwdChannels * kLanes;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kChannelsPerWarp = 32 / kLanes;
  // the lane bits of the plain butterfly levels below the two halving ones
  static constexpr int kPlainMask = 7 & ~(kLanes - 1);
  // floats of shared memory: pre-step states, staged dt/x/dy, ddt/dxc out,
  // staged B_t/C_t, the warps' dB/dC sums
  static constexpr int kSmemFloats =
      kSub * (kSpl * kThreads + 5 * kBwdChannels + 2 * NP +
              kWarps * 2 * NP);
};

template <int NP>
__global__ void __launch_bounds__(BwdShape<NP>::kThreads)
ssm_bwd(const float* __restrict__ xc, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ ckpt,
        const float* __restrict__ dy, float* __restrict__ dxc,
        float* __restrict__ ddt, float* __restrict__ dbm_part,
        float* __restrict__ dcm_part, float* __restrict__ da_part,
        float* __restrict__ dh0, float* __restrict__ starts, int S, int Di,
        int N, int chunk) {
  using Shape = BwdShape<NP>;
  constexpr int T = Shape::kThreads;
  constexpr int LPC = Shape::kLanes;
  constexpr int CH = kBwdChannels;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cl = warp * Shape::kChannelsPerWarp + lane / LPC;
  const int j = lane % LPC;
  const int b = blockIdx.y, blk = blockIdx.x, n_blk = gridDim.x;
  const int d = blk * CH + cl;
  const bool live = d < Di;
  const int n_chunks = S / chunk;
  const int n_sub = (chunk + kSub - 1) / kSub;

  extern __shared__ float smem[];
  float* hs = smem;                          // [kSub][kSpl][T]
  float* s_dt = hs + kSub * kSpl * T;        // [kSub][CH]
  float* s_x = s_dt + kSub * CH;
  float* s_dy = s_x + kSub * CH;
  float* s_ddt = s_dy + kSub * CH;
  float* s_dxc = s_ddt + kSub * CH;
  float* s_b = s_dxc + kSub * CH;            // [kSub][NP]
  float* s_c = s_b + kSub * NP;
  float* red = s_c + kSub * NP;              // [warps][kSub][2 NP]

  int nn[kSpl];
  bool ok[kSpl];
  float av[kSpl], m[kSpl], da[kSpl], h[kSpl];
#pragma unroll
  for (int s = 0; s < kSpl; ++s) {
    nn[s] = j * kSpl + s;
    ok[s] = live && nn[s] < N;
    av[s] = ok[s] ? a[(size_t)d * N + nn[s]] : 0.f;
    m[s] = 0.f;
    da[s] = 0.f;
  }
  const size_t seq = (size_t)b * S * Di;
  const float* Bm = bm + (size_t)b * S * N;
  const float* Cm = cm + (size_t)b * S * N;
  // this thread's sub-chunk start states: [n_sub][kSpl] with stride T
  float* my_starts =
      starts + (size_t)(b * n_blk + blk) * n_sub * kSpl * T + tid;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const float* ck = ckpt + (((size_t)b * n_chunks + c) * Di + d) * N;
#pragma unroll
    for (int s = 0; s < kSpl; ++s) h[s] = ok[s] ? ck[nn[s]] : 0.f;
    // pass 1: the start state of every sub-chunk (all but the last are
    // full), dt and x of a sub-chunk loaded before its walk
    for (int sc = 0; sc < n_sub; ++sc) {
#pragma unroll
      for (int s = 0; s < kSpl; ++s) my_starts[(sc * kSpl + s) * T] = h[s];
      if (sc == n_sub - 1) break;
      const int ts = t0 + sc * kSub;
      float dr[kSub], xr[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const size_t g = seq + (size_t)(ts + i) * Di + d;
        dr[i] = live ? dt[g] : 0.f;
        xr[i] = live ? xc[g] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float dx = dr[i] * xr[i];
        const float* bt = Bm + (size_t)(ts + i) * N;
#pragma unroll
        for (int s = 0; s < kSpl; ++s)
          if (ok[s]) step_state(h[s], av[s], dr[i], dx, bt[nn[s]]);
      }
    }
    // pass 2: each sub-chunk, last first: stage, recompute, walk back
    for (int sc = n_sub - 1; sc >= 0; --sc) {
      const int ts = t0 + sc * kSub;
      const int len = min(kSub, chunk - sc * kSub);
      __syncthreads();                 // the previous sub-chunk is written
      for (int e = tid; e < len * CH; e += T) {
        const int dd = blk * CH + e % CH;
        const size_t g = seq + (size_t)(ts + e / CH) * Di + dd;
        const bool lv = dd < Di;
        s_dt[e] = lv ? dt[g] : 0.f;
        s_x[e] = lv ? xc[g] : 0.f;
        s_dy[e] = lv ? dy[g] : 0.f;
      }
      for (int e = tid; e < len * NP; e += T) {
        const int n = e % NP;
        const size_t g = (size_t)(ts + e / NP) * N + n;
        s_b[e] = n < N ? Bm[g] : 0.f;
        s_c[e] = n < N ? Cm[g] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSpl; ++s) h[s] = my_starts[(sc * kSpl + s) * T];
      // recompute: pre-step states to shared memory, a_bar to registers
      // (a lane whose state is padding computes zeros: a = 0, B = 0)
      float abr[kSub][kSpl];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        if (i < len) {
          const float dtv = s_dt[i * CH + cl];
          const float dx = dtv * s_x[i * CH + cl];
#pragma unroll
          for (int s = 0; s < kSpl; ++s) {
            hs[(i * kSpl + s) * T + tid] = h[s];
            abr[i][s] = step_state(h[s], av[s], dtv, dx, s_b[i * NP + nn[s]]);
          }
        }
      }
      // the reverse walk (len is the same for the whole block)
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        if (i < len) {
          const float dtv = s_dt[i * CH + cl];
          const float xv = s_x[i * CH + cl];
          const float dyv = s_dy[i * CH + cl];
          float v[2 * kSpl];
          float sum_dab = 0.f, sum_lb = 0.f;
#pragma unroll
          for (int s = 0; s < kSpl; ++s) {
            const float hp = hs[(i * kSpl + s) * T + tid];
            const float ab = abr[i][s];
            const float bn = s_b[i * NP + nn[s]];
            const float cn = s_c[i * NP + nn[s]];
            const float hpost = ab * hp + (dtv * xv) * bn;
            const float lam = dyv * cn + m[s];
            const float dab = lam * hp;
            sum_dab += dab * av[s] * ab;
            sum_lb += lam * bn;
            v[s] = lam * dtv * xv;
            v[kSpl + s] = dyv * hpost;
            da[s] += dab * dtv * ab;
            m[s] = ab * lam;
          }
          // ddt and dxc: sum over the channel's lanes
#pragma unroll
          for (int o = 1; o < LPC; o <<= 1) {
            sum_dab += __shfl_xor_sync(kFull, sum_dab, o);
            sum_lb += __shfl_xor_sync(kFull, sum_lb, o);
          }
          if (j == 0) {
            s_ddt[i * CH + cl] = sum_dab + sum_lb * xv;
            s_dxc[i * CH + cl] = sum_lb * dtv;
          }
          // dB and dC: sum over the warp's channels. Lane bit 4 picks dB
          // or dC, bit 3 the state, and plain levels sum the rest
          {
            const bool up = (lane & 16) != 0;
#pragma unroll
            for (int q = 0; q < kSpl; ++q) {
              const float send = up ? v[q] : v[kSpl + q];
              const float keep = up ? v[kSpl + q] : v[q];
              v[q] = keep + __shfl_xor_sync(kFull, send, 16);
            }
          }
          {
            const bool up = (lane & 8) != 0;
            const float send = up ? v[0] : v[1];
            const float keep = up ? v[1] : v[0];
            v[0] = keep + __shfl_xor_sync(kFull, send, 8);
          }
#pragma unroll
          for (int o = 4; o >= LPC; o >>= 1)
            v[0] += __shfl_xor_sync(kFull, v[0], o);
          if ((lane & Shape::kPlainMask) == 0) {
            const int kind = (lane >> 4) & 1, s = (lane >> 3) & 1;
            red[(warp * kSub + i) * 2 * NP + kind * NP + j * kSpl + s] = v[0];
          }
        }
      }
      __syncthreads();
      // the block's dB/dC partial: its warps added in ascending order
      for (int e = tid; e < len * 2 * NP; e += T) {
        const int i = e / (2 * NP), k = e % (2 * NP), n = k % NP;
        if (n < N) {
          float sum = red[i * 2 * NP + k];
#pragma unroll
          for (int w = 1; w < Shape::kWarps; ++w)
            sum += red[(w * kSub + i) * 2 * NP + k];
          const size_t row = (((size_t)b * n_blk + blk) * S + ts + i) * N + n;
          (k < NP ? dbm_part : dcm_part)[row] = sum;
        }
      }
      for (int e = tid; e < len * CH; e += T) {
        const int dd = blk * CH + e % CH;
        if (dd < Di) {
          const size_t g = seq + (size_t)(ts + e / CH) * Di + dd;
          ddt[g] = s_ddt[e];
          dxc[g] = s_dxc[e];
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSpl; ++s) {
    if (ok[s]) {
      dh0[((size_t)b * Di + d) * N + nn[s]] = m[s];
      da_part[((size_t)b * Di + d) * N + nn[s]] = da[s];
    }
  }
}

// out[o, i] = sum over k ascending of in[o, k, i].
__global__ void __launch_bounds__(kSumThreads)
sum_mid(const float* __restrict__ in, float* __restrict__ out, int outer,
        int mid, int inner) {
  const long long idx = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (idx >= (long long)outer * inner) return;
  const long long o = idx / inner, i = idx % inner;
  const float* p = in + (size_t)o * mid * inner + i;
  float s = 0.f;
  for (int k = 0; k < mid; ++k) s += p[(size_t)k * inner];
  out[idx] = s;
}

int sum_launch(const float* in, float* out, int outer, int mid, int inner,
               cudaStream_t stream) {
  const long long total = (long long)outer * inner;
  const long long blocks = (total + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0)
    sum_mid<<<(unsigned)blocks, kSumThreads, 0, stream>>>(in, out, outer, mid,
                                                         inner);
  return (int)cudaGetLastError();
}

// Shared memory of one backward block at N states (bytes), any chunk.
long long bwd_smem_bytes(int N) {
  const int np = N <= 4 ? 4 : (N <= 8 ? 8 : 16);
  const int floats = np == 4 ? BwdShape<4>::kSmemFloats
                     : np == 8 ? BwdShape<8>::kSmemFloats
                               : BwdShape<16>::kSmemFloats;
  return (long long)floats * sizeof(float);
}

}  // namespace

// Forward. xc, dt: [B, S, Di]; bm, cm: [B, S, N]; a: [Di, N]; h0: [B, Di, N];
// outputs y [B, S, Di], ckpt [B, S/chunk, Di, N], ht [B, Di, N]. N <= 16,
// S % chunk == 0 (checked by the wrapper). Returns cudaGetLastError().
extern "C" int ssm_fwd_launch(const float* xc, const float* dt,
                              const float* bm, const float* cm,
                              const float* a, const float* h0, float* y,
                              float* ckpt, float* ht, int B, int S, int Di,
                              int N, int chunk, void* stream) {
  if (N < 1 || N > 16 || chunk < 1 || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Di + kFwdThreads - 1) / kFwdThreads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 4)
    ssm_fwd<4><<<grid, kFwdThreads, 0, st>>>(xc, dt, bm, cm, a, h0, y, ckpt,
                                             ht, S, Di, N, chunk);
  else if (N <= 8)
    ssm_fwd<8><<<grid, kFwdThreads, 0, st>>>(xc, dt, bm, cm, a, h0, y, ckpt,
                                             ht, S, Di, N, chunk);
  else
    ssm_fwd<16><<<grid, kFwdThreads, 0, st>>>(xc, dt, bm, cm, a, h0, y, ckpt,
                                              ht, S, Di, N, chunk);
  return (int)cudaGetLastError();
}

// Backward. Inputs as the forward plus ckpt and dy [B, S, Di]; outputs dxc,
// ddt [B, S, Di], dbm, dcm [B, S, N], da [Di, N], dh0 [B, Di, N]. Scratch:
// part_bm, part_cm [B, ceil(Di/32), S, N], part_da [B, Di, N] and starts
// [B, ceil(Di/32), ceil(chunk/16), 32 NP] (NP = N padded to 4, 8 or 16).
extern "C" int ssm_bwd_launch(const float* xc, const float* dt,
                              const float* bm, const float* cm,
                              const float* a, const float* ckpt,
                              const float* dy, float* dxc, float* ddt,
                              float* dbm, float* dcm, float* da, float* dh0,
                              float* part_bm, float* part_cm, float* part_da,
                              float* starts, int B, int S, int Di, int N,
                              int chunk, void* stream) {
  if (N < 1 || N > 16 || chunk < 1 || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = bwd_smem_bytes(N);
  const int n_blk = (Di + kBwdChannels - 1) / kBwdChannels;
  const dim3 grid(n_blk, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SSM_BWD(NP)                                                          \
  err = cudaFuncSetAttribute(ssm_bwd<NP>,                                    \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                             (int)smem);                                     \
  if (err != cudaSuccess) return (int)err;                                   \
  ssm_bwd<NP><<<grid, BwdShape<NP>::kThreads, (size_t)smem, st>>>(          \
      xc, dt, bm, cm, a, ckpt, dy, dxc, ddt, part_bm, part_cm, part_da, dh0, \
      starts, S, Di, N, chunk);
  if (N <= 4) {
    SSM_BWD(4)
  } else if (N <= 8) {
    SSM_BWD(8)
  } else {
    SSM_BWD(16)
  }
#undef SSM_BWD
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  rc = sum_launch(part_bm, dbm, B, n_blk, S * N, st);
  if (rc != 0) return rc;
  rc = sum_launch(part_cm, dcm, B, n_blk, S * N, st);
  if (rc != 0) return rc;
  return sum_launch(part_da, da, 1, B, Di * N, st);
}

extern "C" const char* ssm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
