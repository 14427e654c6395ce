// WKV6 chunked scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_wkv_kernel` of
// src/repro/kernels/rwkv_scan/kernel.py: the RWKV-6 time-mix recurrence
// per (batch, head),
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,
// from a zero state (or a given one), returning o and the final (dk, dv)
// state, in fp32.
// Within a chunk of L steps the recurrence is closed-form:
//     cum[t]      = sum_{i<=t} log w_i (per channel), cum_prev[t] = cum[t-1]
//     o[t]        = (r[t] e^{cum_prev[t]}) S
//                 + sum_{s<t} (sum_c r[t,c] k[s,c] e^{cum_prev[t,c]-cum[s,c]}) v[s]
//                 + (r[t] . u k[t]) v[t]
//     S'          = e^{cum[L-1]} S + sum_t (k[t] e^{cum[L-1]-cum[t]})^T v[t]
//
// Bound on the H100: bytes. Per token and head the recurrence needs about
// 4 dk dv operations against 4 (dk + dv) input bytes a head, so at
// dk = dv = 64 it sits below the card's fp32 operations-per-byte line.
// This first version does plain fp32 FMAs (no TF32, no tensor cores) and
// recomputes the (L, L) score matrix in every column tile; it is right
// first, fast later. What limits it is instructions, not bytes: the score
// triangle costs an expf and four shared-memory loads a term (on an H100
// 80GB HBM3 at 700 W, 1.33 ms for 2048 tokens x 64 heads of 64 against a
// 0.050 ms bytes bound; chip_smoke.py measures it).
//
// Design. One 256-thread block per (column tile of the state, head,
// batch). Column j of S depends only on v[:, j], so the grid
// (dv / tile, h, b) is exact and puts more blocks on the 132 SMs than
// (h, b) alone would. The TPU grid's sequential chunk axis becomes a loop
// inside the block; the block's (dk, tile) slice of the state stays in
// shared memory across it, starting from zero or from the caller's s0.
// The last chunk may be shorter than the rest (Lc = s - t0 steps): every
// loop of a chunk runs over its own Lc rows. Per chunk: r, k, w, v are staged in shared
// memory (rows padded by one word, so column walks hit distinct banks);
// one thread a channel turns w into cum and cum_prev with a running sum
// while other warps compute the diagonal bonus; the strictly lower
// triangle of scores is evaluated pair by pair; r and k are rescaled in
// place; each thread writes outputs straight to device memory; then the
// state is advanced.
//
// Only pairs s < t are ever evaluated. There cum_prev[t] - cum[s] is a
// sum of logs of decays in (0, 1), so the exponent is <= 0 and never
// overflows: the running sum only decreases, so the difference of its
// rounded values is <= 0 too. (The Pallas kernel computes every pair and
// masks afterwards; a pair with t <= s has a positive exponent, which for
// fast decays overflows to inf, and inf * 0 is NaN.) log w is floored at
// -60: a decay below e^-60 (~1e-26) changes no fp32 result, and a decay
// that underflowed to 0 would otherwise give -inf - -inf = NaN.
//
// Shared memory at L = 64, dk = 64, tile 32: ~101 KB, above the 48 KB
// static limit, so the kernel uses dynamic shared memory after
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize).
//
// Layout: r, k, w (b, s, h, dk) and v (b, s, h, dv) as the model holds
// them, read through their batch/sequence/head strides with the last
// dimension contiguous (no transpose, no copy); u (h, dk) contiguous. o is
// written contiguous (b, s, h, dv), the final state contiguous
// (b, h, dk, dv).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;
constexpr int kMaxDim = 64;
constexpr int kTile = 32;  // state columns per block (at most)
constexpr float kLogFloor = -60.f;

struct Smem {
  int ldk, ldv, lda;
  size_t r, k, cum, prev, v, a, s, diag, u, decay, total;  // float offsets

  __host__ __device__ Smem(int L, int dk, int tv) {
    ldk = dk + 1;
    ldv = tv + 1;
    lda = L + 1;
    size_t off = 0;
    r = off;     off += static_cast<size_t>(L) * ldk;
    k = off;     off += static_cast<size_t>(L) * ldk;
    cum = off;   off += static_cast<size_t>(L) * ldk;
    prev = off;  off += static_cast<size_t>(L) * ldk;
    v = off;     off += static_cast<size_t>(L) * ldv;
    a = off;     off += static_cast<size_t>(L) * lda;
    s = off;     off += static_cast<size_t>(dk) * ldv;
    diag = off;  off += L;
    u = off;     off += dk;
    decay = off; off += dk;
    total = off;
  }
};

__global__ void __launch_bounds__(kThreads)
wkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ o, float* __restrict__ state_out, int s_len, int h_count, int dk,
                int dv, int L, int tv, int64_t r_sb, int64_t r_ss,
                int64_t r_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t w_sb,
                int64_t w_ss, int64_t w_sh) {
  extern __shared__ float smem[];
  const Smem lay(L, dk, tv);
  float* sR = smem + lay.r;
  float* sK = smem + lay.k;
  float* sCum = smem + lay.cum;
  float* sPrev = smem + lay.prev;
  float* sV = smem + lay.v;
  float* sA = smem + lay.a;
  float* sS = smem + lay.s;
  float* sDiag = smem + lay.diag;
  float* sU = smem + lay.u;
  float* sDecay = smem + lay.decay;
  const int ldk = lay.ldk, ldv = lay.ldv, lda = lay.lda;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * tv;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* rb = r + b * r_sb + h * r_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh + j0;
  const float* wb = w + b * w_sb + h * w_sh;

  for (int c = tid; c < dk; c += kThreads) sU[c] = u[h * dk + c];
  const int64_t state_at = (static_cast<int64_t>(b) * h_count + h) * dk * dv + j0;
  for (int idx = tid; idx < dk * tv; idx += kThreads) {
    const int c = idx / tv;
    const int j = idx % tv;
    sS[c * ldv + j] = s0 ? s0[state_at + static_cast<int64_t>(c) * dv + j] : 0.f;
  }

  for (int t0 = 0; t0 < s_len; t0 += L) {
    const int Lc = min(L, s_len - t0);
    const int n_pairs = Lc * (Lc - 1) / 2;
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < Lc * dk; idx += kThreads) {
      const int t = idx / dk;
      const int c = idx % dk;
      const int64_t row = t0 + t;
      sR[t * ldk + c] = rb[row * r_ss + c];
      sK[t * ldk + c] = kb[row * k_ss + c];
      sCum[t * ldk + c] = wb[row * w_ss + c];
    }
    for (int idx = tid; idx < Lc * tv; idx += kThreads) {
      const int t = idx / tv;
      const int j = idx % tv;
      sV[t * ldv + j] = vb[(t0 + t) * v_ss + j];
    }
    __syncthreads();

    // cum / cum_prev (one thread a channel), the diagonal bonus (others)
    if (tid < dk) {
      float run = 0.f;
      for (int t = 0; t < Lc; ++t) {
        const float lw = fmaxf(logf(sCum[t * ldk + tid]), kLogFloor);
        sPrev[t * ldk + tid] = run;
        run += lw;
        sCum[t * ldk + tid] = run;
      }
    } else if (tid >= kMaxDim && tid < kMaxDim + Lc) {
      const int t = tid - kMaxDim;
      float acc = 0.f;
      for (int c = 0; c < dk; ++c)
        acc = fmaf(sR[t * ldk + c] * sU[c], sK[t * ldk + c], acc);
      sDiag[t] = acc;
    }
    __syncthreads();

    // scores of the strictly lower triangle: pair p -> (t, s), s < t
    for (int p = tid; p < n_pairs; p += kThreads) {
      int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * p)) * 0.5f);
      while (t * (t - 1) / 2 > p) --t;
      while ((t + 1) * t / 2 <= p) ++t;
      const int s = p - t * (t - 1) / 2;
      const float* rt = sR + t * ldk;
      const float* pt = sPrev + t * ldk;
      const float* ks = sK + s * ldk;
      const float* cs = sCum + s * ldk;
      float acc = 0.f;
      for (int c = 0; c < dk; ++c)
        acc = fmaf(rt[c] * ks[c], expf(pt[c] - cs[c]), acc);
      sA[t * lda + s] = acc;
    }
    __syncthreads();

    // r decayed back to the chunk start, k decayed to the chunk end
    const float* cum_last = sCum + (Lc - 1) * ldk;
    for (int idx = tid; idx < Lc * dk; idx += kThreads) {
      const int t = idx / dk;
      const int c = idx % dk;
      sR[t * ldk + c] *= expf(sPrev[t * ldk + c]);
      sK[t * ldk + c] *= expf(cum_last[c] - sCum[t * ldk + c]);
    }
    for (int c = tid; c < dk; c += kThreads) sDecay[c] = expf(cum_last[c]);
    __syncthreads();

    // outputs: inter-chunk + intra-chunk + diagonal bonus
    for (int idx = tid; idx < Lc * tv; idx += kThreads) {
      const int t = idx / tv;
      const int j = idx % tv;
      float acc = sDiag[t] * sV[t * ldv + j];
      for (int c = 0; c < dk; ++c) acc = fmaf(sR[t * ldk + c], sS[c * ldv + j], acc);
      for (int s = 0; s < t; ++s) acc = fmaf(sA[t * lda + s], sV[s * ldv + j], acc);
      o[((static_cast<int64_t>(b) * s_len + t0 + t) * h_count + h) * dv + j0 + j] = acc;
    }
    __syncthreads();

    // state to the chunk's end
    for (int idx = tid; idx < dk * tv; idx += kThreads) {
      const int c = idx / tv;
      const int j = idx % tv;
      float acc = sDecay[c] * sS[c * ldv + j];
      for (int t = 0; t < Lc; ++t) acc = fmaf(sK[t * ldk + c], sV[t * ldv + j], acc);
      sS[c * ldv + j] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < dk * tv; idx += kThreads) {
    const int c = idx / tv;
    const int j = idx % tv;
    state_out[state_at + static_cast<int64_t>(c) * dv + j] = sS[c * ldv + j];
  }
}

}  // namespace

// r/k/v/w strides are (batch, seq, head) in elements; the last dim is
// contiguous. u is (h, dk) contiguous; s0 (b, h, dk, dv) contiguous, or
// null for a zero initial state; o (b, s, h, dv) and state (b, h, dk, dv)
// are written contiguous. All fp32. Needs 1 <= chunk <= 64 (the last
// chunk takes what is left of s), and dk, dv <= 64 with dv a multiple of
// min(dv, 32).
// Returns a cudaError_t (0 = ok).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* o, void* state,
                        int b, int s, int h, int dk, int dv, int chunk,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || h <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  const int tv = dv < kTile ? dv : kTile;
  if (chunk < 1 || chunk > kMaxChunk || dk < 1 ||
      dk > kMaxDim || dv < 1 || dv > kMaxDim || dv % tv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Smem(chunk, dk, tv).total * sizeof(float);
  err = cudaFuncSetAttribute(wkv6_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(dv / tv, h, b);
  wkv6_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o),
      static_cast<float*>(state), s, h, dk, dv, chunk, tv, r_sb, r_ss, r_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh);
  return static_cast<int>(cudaGetLastError());
}
