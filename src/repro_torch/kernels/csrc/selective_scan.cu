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
// one exp per state would do, but it computes three (two recomputations
// and the reverse walk).
//
// What the design does about it:
// * forward: one thread per (sequence, channel) holds its N states in
//   registers and walks the whole sequence, so nothing but the kernel's
//   inputs and outputs touches HBM (the TPU kernel's VMEM-resident state).
//   Each block stages B_t and C_t for 16 steps in shared memory and loads its
//   channels' x and dt for those steps into registers first, so the loads
//   are in flight together; y_t = sum_n h*C needs no reduction across
//   threads.
// * backward: one warp per (sequence, 32 channels) walks every chunk of its
//   sequence in reverse, carrying m and the dA accumulator in registers, so
//   dA needs no reduction across blocks (the TPU revisited its output across
//   the sequential grid axis). The reference kept a chunk's pre-step states
//   in a [chunk, bd, N] scratch (2 MiB at chunk 256); here each chunk is cut
//   into sub-chunks of `sub` steps: a first pass from the chunk checkpoint
//   stores the sub-chunk start states in shared memory, then each sub-chunk,
//   last first, is recomputed from its start into shared memory and walked
//   in reverse. Shared memory per warp: (n_sub + sub) * NP * 32 floats
//   (64 KB at chunk 256, sub 16, N 16). h_{t-1} is never recovered by
//   dividing by a_bar.
// * dB and dC reduce over channels: the warp sums its 32 lanes' 2N values
//   per step with a transposing butterfly (31 shuffles for 2N = 32), writes
//   one partial per (sequence, channel block), and a second kernel sums the
//   partials over blocks in ascending order. dA sums its per-sequence
//   partials over the batch the same way. No float atomics: two runs give
//   the same bits, and a sequence gives the same bits alone as in a batch.

#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 64;   // channels per forward block
constexpr int kTile = 16;         // steps staged per forward tile
constexpr int kWarp = 32;         // channels per backward block
constexpr int kSumThreads = 256;

// One recurrence step for channel state h (the forward and both backward
// recomputations share it, so they produce the same states).
template <int NP>
__device__ __forceinline__ void advance(float (&h)[NP], const float (&av)[NP],
                                        float dtv, float xv, const float* bt,
                                        int N) {
  const float dx = dtv * xv;
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    if (n < N) {
      const float ab = expf(dtv * av[n]);
      h[n] = ab * h[n] + dx * bt[n];
    }
  }
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

// Sums V values across the warp's 32 lanes at once: lane L ends with the
// sum of value L / (32 / V) in v[0]. Each halving step sends half of the
// values to the partner lane and keeps the other half; the order of the
// additions is fixed by the lane numbers.
template <int V>
__device__ __forceinline__ float warp_transpose_sum(float (&v)[V], int lane) {
  constexpr int kSteps = V == 32 ? 5 : (V == 16 ? 4 : 3);   // log2(V)
  static_assert(V == 1 << kSteps, "V must be 8, 16 or 32");
#pragma unroll
  for (int step = 0; step < kSteps; ++step) {
    const int half = V >> (step + 1);
    const int m = 16 >> step;
    const bool up = (lane & m) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float lo = v[j], hi = v[j + half];
      const float send = up ? lo : hi;
      const float keep = up ? hi : lo;
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
#pragma unroll
  for (int m = 16 >> kSteps; m >= 1; m >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
  return v[0];
}

template <int NP>
__global__ void __launch_bounds__(kWarp)
ssm_bwd(const float* __restrict__ xc, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ ckpt,
        const float* __restrict__ dy, float* __restrict__ dxc,
        float* __restrict__ ddt, float* __restrict__ dbm_part,
        float* __restrict__ dcm_part, float* __restrict__ da_part,
        float* __restrict__ dh0, int S, int Di, int N, int chunk, int sub) {
  constexpr int V = 2 * NP;
  constexpr int R = kWarp / V;           // lanes holding each reduced value
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int n_blk = gridDim.x;
  const int lane = threadIdx.x;
  const int d = blk * kWarp + lane;
  const bool live = d < Di;
  const int n_chunks = S / chunk;
  const int n_sub = (chunk + sub - 1) / sub;
  extern __shared__ float smem[];
  float* starts = smem;                          // [n_sub][NP][32]
  float* hs = smem + (size_t)n_sub * NP * kWarp;  // [sub][NP][32]

  float av[NP], m[NP], da[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    av[n] = (live && n < N) ? a[(size_t)d * N + n] : 0.f;
    m[n] = 0.f;
    da[n] = 0.f;
  }
  const size_t seq = (size_t)b * S * Di;
  const float* Bm = bm + (size_t)b * S * N;
  const float* Cm = cm + (size_t)b * S * N;
  auto load = [&](const float* base, int t) {
    return live ? base[seq + (size_t)t * Di + d] : 0.f;
  };

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const float* ck = ckpt + (((size_t)b * n_chunks + c) * Di + d) * N;
#pragma unroll
    for (int n = 0; n < NP; ++n) h[n] = (live && n < N) ? ck[n] : 0.f;
    // pass 1: the start state of every sub-chunk
    for (int s = 0; s < n_sub; ++s) {
#pragma unroll
      for (int n = 0; n < NP; ++n) starts[(s * NP + n) * kWarp + lane] = h[n];
      if (s == n_sub - 1) break;
      for (int t = t0 + s * sub; t < t0 + (s + 1) * sub; ++t)
        advance<NP>(h, av, load(dt, t), load(xc, t), Bm + (size_t)t * N, N);
    }
    // pass 2: each sub-chunk, last first: recompute, then walk back
    for (int s = n_sub - 1; s >= 0; --s) {
      const int ts = t0 + s * sub;
      const int len = min(sub, t0 + chunk - ts);
#pragma unroll
      for (int n = 0; n < NP; ++n) h[n] = starts[(s * NP + n) * kWarp + lane];
      for (int i = 0; i < len; ++i) {
#pragma unroll
        for (int n = 0; n < NP; ++n) hs[(i * NP + n) * kWarp + lane] = h[n];
        advance<NP>(h, av, load(dt, ts + i), load(xc, ts + i),
                    Bm + (size_t)(ts + i) * N, N);
      }
      for (int i = len - 1; i >= 0; --i) {
        const int t = ts + i;
        const float dtv = load(dt, t), xv = load(xc, t), dyv = load(dy, t);
        const float* bt = Bm + (size_t)t * N;
        const float* ct = Cm + (size_t)t * N;
        float v[V];
        float sum_dab = 0.f, sum_lb = 0.f;
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          if (n < N) {
            const float hp = hs[(i * NP + n) * kWarp + lane];
            const float ab = expf(dtv * av[n]);
            const float bn = bt[n];
            const float hpost = ab * hp + (dtv * xv) * bn;
            const float lam = dyv * ct[n] + m[n];
            const float dab = lam * hp;
            sum_dab += dab * av[n] * ab;
            sum_lb += lam * bn;
            v[n] = lam * dtv * xv;
            v[NP + n] = dyv * hpost;
            da[n] += dab * dtv * ab;
            m[n] = ab * lam;
          } else {
            v[n] = 0.f;
            v[NP + n] = 0.f;
          }
        }
        if (live) {
          ddt[seq + (size_t)t * Di + d] = sum_dab + sum_lb * xv;
          dxc[seq + (size_t)t * Di + d] = sum_lb * dtv;
        }
        const float red = warp_transpose_sum<V>(v, lane);
        if (lane % R == 0) {
          const int k = lane / R;
          const size_t row = (((size_t)b * n_blk + blk) * S + t) * N;
          if (k < N) dbm_part[row + k] = red;
          else if (k >= NP && k < NP + N) dcm_part[row + k - NP] = red;
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      if (n < N) {
        dh0[((size_t)b * Di + d) * N + n] = m[n];
        da_part[((size_t)b * Di + d) * N + n] = da[n];
      }
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

// Shared memory the backward kernel needs for these sizes (bytes).
long long bwd_smem_bytes(int N, int chunk, int sub) {
  const int np = N <= 4 ? 4 : (N <= 8 ? 8 : 16);
  const long long n_sub = (chunk + sub - 1) / sub;
  return (n_sub + sub) * np * kWarp * (long long)sizeof(float);
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
// part_bm, part_cm [B, ceil(Di/32), S, N] and part_da [B, Di, N]. `sub` is
// the sub-chunk length (1 <= sub <= chunk).
extern "C" int ssm_bwd_launch(const float* xc, const float* dt,
                              const float* bm, const float* cm,
                              const float* a, const float* ckpt,
                              const float* dy, float* dxc, float* ddt,
                              float* dbm, float* dcm, float* da, float* dh0,
                              float* part_bm, float* part_cm, float* part_da,
                              int B, int S, int Di, int N, int chunk, int sub,
                              void* stream) {
  if (N < 1 || N > 16 || chunk < 1 || S % chunk != 0 || sub < 1 ||
      sub > chunk)
    return (int)cudaErrorInvalidValue;
  const long long smem = bwd_smem_bytes(N, chunk, sub);
  const int n_blk = (Di + kWarp - 1) / kWarp;
  const dim3 grid(n_blk, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SSM_BWD(NP)                                                          \
  err = cudaFuncSetAttribute(ssm_bwd<NP>,                                    \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                             (int)smem);                                     \
  if (err != cudaSuccess) return (int)err;                                   \
  ssm_bwd<NP><<<grid, kWarp, (size_t)smem, st>>>(                            \
      xc, dt, bm, cm, a, ckpt, dy, dxc, ddt, part_bm, part_cm, part_da, dh0, \
      S, Di, N, chunk, sub);
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
