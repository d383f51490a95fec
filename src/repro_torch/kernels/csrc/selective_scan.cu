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
// * forward: each (sequence, channel) walks the whole sequence with its N
//   states in registers, so nothing but the kernel's inputs and outputs
//   touches HBM (the TPU kernel's VMEM-resident state). The first design
//   gave each channel one thread (16384 threads, 64-thread blocks: about
//   one warp per scheduler at the training shape), so the 16 exps and the
//   serial 16-term y sum of a step had nothing to hide their latency, and
//   every 16 steps a __syncthreads waited on cold global loads: 2.4 ms,
//   about 12 clocks per instruction. Now a channel's states are split
//   over kFwdLanes lanes (FwdShape: NP / lanes states a lane, 4 at N = 16),
//   so a block of 32 channels has 32 x lanes threads and the training shape
//   about 15 warps an SM (four lanes measured faster than two or eight,
//   tools/scan_fwd_steps.py); y_t is a per-lane partial sum closed by a fixed
//   butterfly of log2(lanes) shuffles, in the same order for every channel
//   and sequence. x_t and dt_t (one value a channel) and the B_t, C_t rows
//   (shared by every channel of the block) are staged in shared memory for
//   kFwdTile steps by cp.async, 16 bytes a copy where the rows allow it,
//   one tile ahead of the steps (two stages); y goes to shared memory and
//   out as whole rows of the block's channels. Every state update is
//   step_state, as before, so the checkpoints and hT are bit-equal to the
//   first design's (only y's summation order changed), and the backward's
//   recomputation still matches them bit for bit. No fast-math exp: it
//   would change the states' bits, and the backward's with them.
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

#include <cstdint>

namespace {

constexpr int kFwdLanes = 4;      // lanes a channel in the forward kernel
constexpr int kFwdChannels = 32;  // channels per forward block
constexpr int kFwdTile = 32;      // steps per staged forward tile
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

// cp.async copies into shared memory (sm_80 and later), their groups and
// the wait for all but the newest `pending` groups.
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

// Forward block shape for NP padded states: lanes a channel (kFwdLanes, or
// NP if fewer), NP / lanes states a lane, kFwdChannels channels a block.
template <int NP>
struct FwdShape {
  static constexpr int kLanes = NP < kFwdLanes ? NP : kFwdLanes;
  static constexpr int kSpl = NP / kLanes;            // states a lane
  static constexpr int kThreads = kFwdChannels * kLanes;
  // floats of one stage: x, dt [tile][channels], B_t, C_t [tile][NP]
  static constexpr int kStageFloats = kFwdTile * (2 * kFwdChannels + 2 * NP);
  // two stages and y [tile][channels]
  static constexpr int kSmemFloats =
      2 * kStageFloats + kFwdTile * kFwdChannels;
};

// Stage steps [t0, t0 + tn) of a block's x and dt columns ([tile][CH]) and of
// B and C ([tile][NP]) into `st`; rows past the sequence, channels past Di
// and states past N are zero. vec_x: x and dt rows allow 16-byte copies
// (Di % 4 == 0, aligned); vec_bc: N == NP and B, C aligned.
template <int NP>
__device__ __forceinline__ void fwd_stage(
    float* st, const float* X, const float* T, const float* Bm,
    const float* Cm, int t0, int tn, int d0, int Di, int N, bool vec_x,
    bool vec_bc) {
  constexpr int CH = kFwdChannels, TL = kFwdTile;
  constexpr int THR = FwdShape<NP>::kThreads;
  float* s_x = st;
  float* s_dt = s_x + TL * CH;
  float* s_b = s_dt + TL * CH;
  float* s_c = s_b + TL * NP;
  const int tid = threadIdx.x;
  if (vec_x) {
    for (int e = tid; e < TL * CH / 4; e += THR) {
      const int tt = e / (CH / 4), c = (e % (CH / 4)) * 4;
      float* dx = s_x + tt * CH + c;
      float* dd = s_dt + tt * CH + c;
      if (tt < tn && d0 + c < Di) {
        const size_t g = (size_t)(t0 + tt) * Di + d0 + c;
        cp_async16(dx, X + g);
        cp_async16(dd, T + g);
      } else {
        *reinterpret_cast<float4*>(dx) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dd) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = tid; e < TL * CH; e += THR) {
      const int tt = e / CH, c = e % CH;
      if (tt < tn && d0 + c < Di) {
        const size_t g = (size_t)(t0 + tt) * Di + d0 + c;
        cp_async4(s_x + e, X + g);
        cp_async4(s_dt + e, T + g);
      } else {
        s_x[e] = 0.f;
        s_dt[e] = 0.f;
      }
    }
  }
  if (vec_bc) {                      // N == NP: the rows are contiguous
    for (int e = tid; e < TL * NP / 4; e += THR) {
      const int tt = (e * 4) / NP;
      float* db = s_b + e * 4;
      float* dc = s_c + e * 4;
      if (tt < tn) {
        const size_t g = (size_t)t0 * N + e * 4;
        cp_async16(db, Bm + g);
        cp_async16(dc, Cm + g);
      } else {
        *reinterpret_cast<float4*>(db) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dc) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = tid; e < TL * NP; e += THR) {
      const int tt = e / NP, n = e % NP;
      if (tt < tn && n < N) {
        const size_t g = (size_t)(t0 + tt) * N + n;
        cp_async4(s_b + e, Bm + g);
        cp_async4(s_c + e, Cm + g);
      } else {
        s_b[e] = 0.f;
        s_c[e] = 0.f;
      }
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(FwdShape<NP>::kThreads)
ssm_fwd(const float* __restrict__ xc, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ h0,
        float* __restrict__ y, float* __restrict__ ckpt,
        float* __restrict__ ht, int S, int Di, int N, int chunk, int vec_x,
        int vec_bc) {
  using Shape = FwdShape<NP>;
  constexpr int L = Shape::kLanes, SPL = Shape::kSpl, THR = Shape::kThreads;
  constexpr int CH = kFwdChannels, TL = kFwdTile;
  const int tid = threadIdx.x;
  const int cl = tid / L, j = tid % L;
  const int b = blockIdx.y, d0 = blockIdx.x * CH, d = d0 + cl;
  const bool live = d < Di;
  const int n_chunks = S / chunk;
  const int n_tiles = (S + TL - 1) / TL;
  __shared__ __align__(16) float smem[Shape::kSmemFloats];
  float* ys = smem + 2 * Shape::kStageFloats;         // [tile][channels]

  float h[SPL], av[SPL];
  bool ok[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int n = j * SPL + s;
    ok[s] = live && n < N;
    h[s] = ok[s] ? h0[((size_t)b * Di + d) * N + n] : 0.f;
    av[s] = ok[s] ? a[(size_t)d * N + n] : 0.f;
  }
  const float* X = xc + (size_t)b * S * Di;
  const float* T = dt + (size_t)b * S * Di;
  const float* Bm = bm + (size_t)b * S * N;
  const float* Cm = cm + (size_t)b * S * N;
  float* Y = y + (size_t)b * S * Di;

  fwd_stage<NP>(smem, X, T, Bm, Cm, 0, min(TL, S), d0, Di, N, vec_x,
                vec_bc);
  cp_async_commit();
  int next_ck = 0;                   // the next step that starts a chunk
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * TL, tn = min(TL, S - t0);
    const float* st = smem + (k & 1) * Shape::kStageFloats;
    // the stage of tile k + 1 was last read in tile k - 1, before the
    // barrier that ended it
    if (k + 1 < n_tiles)
      fwd_stage<NP>(smem + ((k + 1) & 1) * Shape::kStageFloats, X, T, Bm, Cm,
                    t0 + TL, min(TL, S - t0 - TL), d0, Di, N, vec_x, vec_bc);
    cp_async_commit();
    cp_async_wait<1>();              // tile k has landed, k + 1 in flight
    __syncthreads();                 // tile k visible; y of tile k - 1 out
    const float* s_x = st;
    const float* s_dt = s_x + TL * CH;
    const float* s_b = s_dt + TL * CH;
    const float* s_c = s_b + TL * NP;
    for (int tt = 0; tt < tn; ++tt) {
      const int t = t0 + tt;
      if (t == next_ck) {
        float* ck = ckpt + (((size_t)b * n_chunks + t / chunk) * Di + d) * N;
#pragma unroll
        for (int s = 0; s < SPL; ++s)
          if (ok[s]) ck[j * SPL + s] = h[s];
        next_ck += chunk;
      }
      const float dtv = s_dt[tt * CH + cl];
      const float dx = dtv * s_x[tt * CH + cl];
      float part = 0.f;
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        if (ok[s]) {
          step_state(h[s], av[s], dtv, dx, s_b[tt * NP + j * SPL + s]);
          part = fmaf(h[s], s_c[tt * NP + j * SPL + s], part);
        }
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
        part += __shfl_xor_sync(kFull, part, o);
      if (j == 0) ys[tt * CH + cl] = part;
    }
    __syncthreads();                 // y of tile k complete; stage k read
    if (vec_x) {
      for (int e = tid; e < tn * CH / 4; e += THR) {
        const int tt = e / (CH / 4), c = (e % (CH / 4)) * 4;
        if (d0 + c < Di)
          *reinterpret_cast<float4*>(Y + (size_t)(t0 + tt) * Di + d0 + c) =
              *reinterpret_cast<const float4*>(ys + tt * CH + c);
      }
    } else {
      for (int e = tid; e < tn * CH; e += THR) {
        const int tt = e / CH, c = e % CH;
        if (d0 + c < Di) Y[(size_t)(t0 + tt) * Di + d0 + c] = ys[e];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < SPL; ++s)
    if (ok[s]) ht[((size_t)b * Di + d) * N + j * SPL + s] = h[s];
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
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<std::uintptr_t>(p) & 15) != 0;
  };
  const int vec_x = Di % 4 == 0 && !misaligned(xc) && !misaligned(dt) &&
                    !misaligned(y);
  const int np = N <= 4 ? 4 : (N <= 8 ? 8 : 16);
  const int vec_bc = N == np && !misaligned(bm) && !misaligned(cm);
  const dim3 grid((Di + kFwdChannels - 1) / kFwdChannels, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SSM_FWD(NP)                                                          \
  ssm_fwd<NP><<<grid, FwdShape<NP>::kThreads, 0, st>>>(                      \
      xc, dt, bm, cm, a, h0, y, ckpt, ht, S, Di, N, chunk, vec_x, vec_bc);
  if (np == 4) {
    SSM_FWD(4)
  } else if (np == 8) {
    SSM_FWD(8)
  } else {
    SSM_FWD(16)
  }
#undef SSM_FWD
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
