// WKV6 chunked scan (forward) for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` of
// src/repro/kernels/rwkv_scan/kernel.py: the RWKV-6 time-mix recurrence
// per (batch, head),
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,
// from a zero state (or a given one), returning o and the final (dk, dv)
// state, in fp32. Within a chunk of L steps the recurrence is closed-form
// (the Pallas kernel's math):
//     cum[t] = sum_{i<=t} log w_i (per channel), cum_prev[t] = cum[t-1], 0 at t = 0
//     o[t]   = (r[t] e^{cum_prev[t]}) S + sum_{s<t} A[t,s] v[s] + (r[t] . u k[t]) v[t]
//     A[t,s] = sum_c r[t,c] k[s,c] e^{cum_prev[t,c] - cum[s,c]}
//     S'     = e^{cum[L-1]} S + sum_t (k[t] e^{cum[L-1] - cum[t]})^T v[t]
// The closed form holds for any L, so a chunk of L steps is taken as one of
// L rounded up to 16, the kernel's row tile (a chunk of 8 costs no more
// than one of 16).
//
// Bound on the H100: bytes. A token and head need 4 (dk + dv) input bytes
// and about 4 dk dv operations of the recurrence, so at dk = dv = 64 it
// sits below the card's operations-per-byte line; chip_smoke.py times it
// against that bound.
//
// Scores by reference points. The chunk is cut into sub-chunks of 16 rows.
// For t in sub-chunk i and s before it (s < start_i), with
// ref_i = cum[start_i - 1],
//     A[t,s] = sum_c (r[t,c] e^{cum_prev[t,c] - ref_i,c}) (k[s,c] e^{ref_i,c - cum[s,c]}).
// log w < 0, so cum only falls: cum_prev[t] <= ref_i <= cum[s], and both
// exponents are <= 0. Neither factor overflows; where one underflows to 0
// the exact product is smaller still. So the scores of a sub-chunk against
// every earlier row are one product (16 x dk)(dk x start_i) on the tensor
// cores. Only the four diagonal 16 x 16 blocks (120 pairs each, and the u
// bonus on the diagonal) are evaluated pair by pair, with the decay
// e^{cum_prev[t] - cum[s]} carried down the rows as the product of the
// decays between s and t: factors <= 1, one multiply a step. Every
// exponent the kernel evaluates is a difference that is <= 0 in exact
// arithmetic; it is clamped at 0, so the rounding of the sums cannot make
// it positive. (The Pallas kernel evaluates every pair and masks
// afterwards; a pair with t <= s has a positive exponent, which for fast
// decays overflows to inf, and inf * 0 is NaN.) log w is floored at -60
// (w at e^-60): a decay below that changes no fp32 result, and a decay
// that underflowed to 0 would otherwise give -inf - -inf = NaN. Logs and
// sums are kept in log2 units, so the exponentials are single
// special-function-unit instructions (ex2.approx, relative error ~2^-22).
// The logs are log2f, within an ulp of the result: lg2.approx's error is
// absolute (~2^-22), and near w = 1, where log w is small (log2 0.9975 =
// -0.0036, rwkv's initial decays), that is ~4e-5 relative a log, which
// moved a 4-layer rwkv6-7b's fp32 loss 1.4e-5 from the plain path's.
//
// Products. All four, r~ k~^T (scores), A V, (r e^{cum_prev}) S and
// (k e^{cum_last - cum})^T V, are mma.sync m16n8k8 TF32 with the 3xTF32
// split (x = big + small, both rounded to TF32 as cvt.rna.tf32.f32 does;
// big*big + big*small + small*big), so they keep fp32 accuracy; each
// product keeps big*big and the two small terms in separate accumulators,
// and even and odd steps in separate sets, to shorten the tensor-core
// chains. Products whose inner dimension is time read time rows 2q and
// 2q + 1 where the fragment layout says q and q + 4 (the sum is the same
// under any permutation of its terms that A and B share), so those
// fragments are float2 loads.
//
// Design. One 512-thread block per (column tile of the state, head,
// batch); the host takes the whole head (tile = dv) unless the grid would
// fill at most half the SMs, then two column tiles (each computes the
// scores). The TPU grid's sequential chunk axis is a loop inside the
// block; every chunk, a ragged last one too, is computed at the first
// chunk's padded length (rows past the end arrive as zeros and do
// nothing), so each warp's share of the work is fixed and its tile loops
// unroll at compile time (the kernel is a template on the key head size
// and on the tiles a warp holds). Per chunk:
//   1. all warps wait for the chunk's r, k, w, v and take cum by a warp
//      prefix sum over the rows (shuffles), eight rows a block and the
//      blocks' carries added after;
//   2. the last warp, the loader, copies the next chunk into the other of
//      two shared-memory stages with cp.async (a copy waits for room among
//      the SM's outstanding loads, so no other warp issues one); the others
//      compute the scores into A in shared memory as jobs: 8 x 8 of a
//      diagonal block (lane (g, q): column g, a quarter of the channels,
//      the four lanes of a column summed by a reduce-scatter of shuffles),
//      or two 8-column tiles of a sub-chunk's product with the rows before
//      it; then decay r to the chunk's start and k to its end, in place;
//   3. all warps: the outputs, (r e^{cum_prev}) S + A V over a sub-chunk's
//      rows and the warp's column tiles, written straight to device
//      memory; and the state update, whose accumulators each warp keeps in
//      registers across chunks and publishes to the other of two
//      shared-memory copies of S.
// Shared memory at L = 64, dk = dv = 64: 212,496 bytes (one block an SM),
// sized to the call's chunk so short chunks fit more blocks an SM. Built
// with -DWKV6_PHASE_CYCLES, the kernel also counts each warp's busy cycles
// in each phase (scripts/wkv6_phase_cycles.py reads them).
//
// Layout: r, k, w (b, s, h, dk) and v (b, s, h, dv) as the model holds
// them, read through their batch/sequence/head strides with the last
// dimension contiguous (no transpose, no copy); 16-byte copies where every
// row starts 16-byte aligned, 4-byte copies otherwise. u (h, dk)
// contiguous. o is written contiguous (b, s, h, dv), the final state
// contiguous (b, h, dk, dv).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;
constexpr int kMaxDim = 64;
constexpr int kSub = 16;                      // rows a sub-chunk
constexpr float kLog2E = 1.4426950408889634f;
constexpr float kLog2Floor = -60.f * kLog2E;  // log w >= -60
constexpr float kWFloor = 8.75651076e-27f;     // e^-60, the same floor on w
constexpr unsigned kFull = 0xffffffffu;

#ifdef WKV6_PHASE_CYCLES
// Busy cycles (clock64, barrier waits excluded) of each warp of block
// (0, 0, 0) in each phase, summed over the chunks after the first:
// scan, scores (the loader: its copies), decay pass, outputs, state.
constexpr int kPhases = 5;
__device__ unsigned long long g_phase_cycles[kPhases][kWarps];
#define PHASE_BEGIN() long long phase_t0 = clock64()
#define PHASE_RESTART() phase_t0 = clock64()
#define PHASE_END(i)                                                              \
  do {                                                                            \
    if (n > 0 && (threadIdx.x & 31) == 0 && blockIdx.x == 0 && blockIdx.y == 0 && \
        blockIdx.z == 0)                                                          \
      g_phase_cycles[i][threadIdx.x >> 5] += clock64() - phase_t0;                \
  } while (0)
#else
#define PHASE_BEGIN()
#define PHASE_RESTART()
#define PHASE_END(i)
#endif

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;  // or null
  float* o;
  float* state;
  int s_len, h, dk, dv, chunk, tv, vec4;
  long long r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh;
};

__host__ __device__ inline int round16(int n) { return (n + kSub - 1) / kSub * kSub; }

// Warps that share one sub-chunk's outputs (a power of two), and warps
// that share one 16-row block of the state.
__host__ __device__ inline int out_warps(int nsub) {
  const int w = kWarps / nsub;
  return w >= 16 ? 16 : w >= 8 ? 8 : 4;
}
__host__ __device__ inline int state_warps(int dk) { return kWarps / ((dk + kSub - 1) / kSub); }
// 8-column tiles a warp holds when `warps` share `tiles`
__host__ __device__ inline int tiles_a_warp(int tiles, int warps) {
  return tiles > warps ? tiles / warps : 1;
}

// Float offsets in dynamic shared memory for chunks of `lp` rows (a
// multiple of 16). Row strides: ldk, ldv = 4 mod 8 words, so fragment
// reads of rows g (or 2q) and columns q (or g) hit 32 distinct banks;
// lda, lds = 8 mod 32 for the float2 reads and writes of accumulators.
struct Smem {
  int ldk, ldv, lda, lds;
  int r[2], k[2], w[2], v[2], cum, a, s[2], u, total;

  __host__ __device__ Smem(int lp, int dk, int tv) {
    ldk = dk + 4;
    ldv = tv + 4;
    lda = lp + 8;
    lds = tv + 8;
    int off = 0;
    for (int i = 0; i < 2; ++i) {
      r[i] = off; off += lp * ldk;
      k[i] = off; off += lp * ldk;
      w[i] = off; off += lp * ldk;
      v[i] = off; off += lp * ldv;
    }
    cum = off + ldk;  // row -1 of cum is zeros: cum_prev[t] = cum[t - 1]
    off += (lp + 1) * ldk;
    a = off;    off += lp * lda;
    s[0] = off; off += dk * lds;
    s[1] = off; off += dk * lds;
    u = off;    off += dk;
    total = off;
  }
};

// e^(x ln 2) for an exponent that is <= 0 in exact arithmetic
__device__ __forceinline__ float decay2(float x) { return hopper::exp2_approx(fminf(x, 0.f)); }

// A fragment (4 values a lane) and B fragment (2), each as TF32 big and
// small parts: x = big + small to ~2^-22 relative
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(int i, float x) {
    big[i] = hopper::tf32(x);
    small[i] = hopper::tf32(x - __uint_as_float(big[i]));
  }
};
struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(int i, float x) {
    big[i] = hopper::tf32(x);
    small[i] = hopper::tf32(x - __uint_as_float(big[i]));
  }
};

// a b in 3xTF32: big*big into db, the two small terms into ds
__device__ __forceinline__ void mma3(float (&db)[4], float (&ds)[4], const FragA& a,
                                     const FragB& b) {
  hopper::mma_m16n8k8_tf32(ds, a.small, b.big);
  hopper::mma_m16n8k8_tf32(db, a.big, b.big);
  hopper::mma_m16n8k8_tf32(ds, a.big, b.small);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Rows [0, lp) of one (b, s, h, cols) tensor into shared memory (row
// stride ld) by the 32 lanes of one warp, 2^shift copies a row of 16 bytes
// (vec4) or 4; rows at or past `live` are zero-filled.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           long long row_stride, int shift, int live, int lp,
                                           bool vec4) {
  const int width = vec4 ? 4 : 1;
  for (int idx = threadIdx.x & 31; idx < lp << shift; idx += 32) {
    const int t = idx >> shift;
    const int c = (idx - (t << shift)) * width;
    const bool on = t < live;
    const float* from = on ? src + t * row_stride + c : src;
    const uint32_t to = hopper::smem_addr(dst + t * ld + c);
    if (vec4)
      hopper::cp_async16(to, from, on);
    else
      hopper::cp_async4(to, from, on);
  }
}

__device__ __forceinline__ int log2_int(int n) { return 31 - __clz(n); }

// Shared-memory views of one chunk
struct Chunk {
  const float* r;
  const float* k;
  const float* w;  // floored at e^-60 by the scan
  const float* prev;  // cum_prev: cum one row up
  const float* cum;
  const float* v;
  const float* u;
  float* a;
  int ldk, ldv, lda, g, q;
};

// Scores of sub-chunk i's rows against rows [16 jp, 16 jp + 16) before it
// (two 8-column tiles), through ref_i = cum[16 i - 1], into A.
template <int DK>
__device__ __forceinline__ void off_diagonal(const Chunk& ch, int i, int jp) {
  const int ldk = ch.ldk, g = ch.g, q = ch.q;
  const int t_lo = kSub * i + g, t_hi = t_lo + 8;
  const float* ref = ch.cum + (kSub * i - 1) * ldk;
  // two accumulator sets, even and odd steps, halve the tensor-core chains
  float db[2][2][4] = {}, ds[2][2][4] = {};
#pragma unroll
  for (int kc = 0; kc < DK / 8; ++kc) {
    const int ca = 8 * kc + q, cb = ca + 4, e = kc & 1;
    const float ref_a = ref[ca], ref_b = ref[cb];
    FragA a;
    a.set(0, ch.r[t_lo * ldk + ca] * decay2(ch.prev[t_lo * ldk + ca] - ref_a));
    a.set(1, ch.r[t_hi * ldk + ca] * decay2(ch.prev[t_hi * ldk + ca] - ref_a));
    a.set(2, ch.r[t_lo * ldk + cb] * decay2(ch.prev[t_lo * ldk + cb] - ref_b));
    a.set(3, ch.r[t_hi * ldk + cb] * decay2(ch.prev[t_hi * ldk + cb] - ref_b));
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int s = 8 * (2 * jp + nn) + g;
      FragB bf;
      bf.set(0, ch.k[s * ldk + ca] * decay2(ref_a - ch.cum[s * ldk + ca]));
      bf.set(1, ch.k[s * ldk + cb] * decay2(ref_b - ch.cum[s * ldk + cb]));
      mma3(db[e][nn], ds[e][nn], a, bf);
    }
  }
#pragma unroll
  for (int nn = 0; nn < 2; ++nn) {
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = (ds[0][nn][j] + ds[1][nn][j]) + (db[0][nn][j] + db[1][nn][j]);
    const int col = 8 * (2 * jp + nn) + 2 * q;
    store2(ch.a + t_lo * ch.lda + col, x[0], x[1]);
    store2(ch.a + t_hi * ch.lda + col, x[2], x[3]);
  }
}

// N floats from shared memory (16-byte vectors where N allows)
template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(src + c);
      dst[c] = x.x; dst[c + 1] = x.y; dst[c + 2] = x.z; dst[c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 x = load2(src + c);
      dst[c] = x.x; dst[c + 1] = x.y;
    }
  }
}

// 8 rows x 8 columns of sub-chunk i's diagonal block, pair by pair: rows
// 16 i + rb .. + 7, columns 16 i + sb .. + 7; s < t a score, s = t the u
// bonus, s > t zero. Lane (g, q) takes column s = 16 i + sb + g and a
// quarter of the channels, and walks the rows carrying k[s] times each
// channel's decay e^{cum_prev[t] - cum[s]} as a product of the decays
// between s and t (w, floored as log w is): one multiply a step, no
// exponential. Where the rows start past the column block, the product
// starts from one exp2 a channel.
template <int DK>
__device__ __forceinline__ void diagonal(const Chunk& ch, int i, int rb, int sb) {
  constexpr int CW = DK / 4;
  const int ldk = ch.ldk, g = ch.g, q = ch.q;
  const int s = kSub * i + sb + g, t0 = kSub * i + rb;
  const int c0 = q * CW;
  const bool on_diagonal = rb == sb;
  float kk[CW], kf[CW];
  load_row(kk, ch.k + s * ldk + c0);
  float bonus = 0.f;
  if (on_diagonal) {
    // kf restarts at k[s] on row s; the bonus r[s] . u k[s]
    float rs[CW], us[CW];
    load_row(rs, ch.r + s * ldk + c0);
    load_row(us, ch.u + c0);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      kf[c] = kk[c];
      bonus = fmaf(rs[c] * us[c], kk[c], bonus);
    }
  } else {
    float ref[CW], cs[CW];
    load_row(ref, ch.cum + (t0 - 1) * ldk + c0);
    load_row(cs, ch.cum + s * ldk + c0);
#pragma unroll
    for (int c = 0; c < CW; ++c) kf[c] = kk[c] * decay2(ref[c] - cs[c]);
  }
  float v[8];
#pragma unroll
  for (int tl = 0; tl < 8; ++tl) {
    const int t = t0 + tl;
    float rt[CW], wt[CW];
    load_row(rt, ch.r + t * ldk + c0);
    load_row(wt, ch.w + t * ldk + c0);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc = fmaf(rt[c], kf[c], acc);
    if (on_diagonal) {
#pragma unroll
      for (int c = 0; c < CW; ++c) kf[c] = t == s ? kk[c] : kf[c] * wt[c];
      v[tl] = t > s ? acc : t == s ? bonus : 0.f;
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c) kf[c] *= wt[c];
      v[tl] = acc;
    }
  }
  // sum over the column's four lanes, scattered: lane q ends with rows
  // 2q and 2q + 1
  const bool hi2 = q & 2, hi1 = q & 1;
  float w4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = hi2 ? v[j] : v[j + 4];
    w4[j] = (hi2 ? v[j + 4] : v[j]) + __shfl_xor_sync(kFull, send, 2);
  }
  float x[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = hi1 ? w4[j] : w4[j + 2];
    x[j] = (hi1 ? w4[j + 2] : w4[j]) + __shfl_xor_sync(kFull, send, 1);
  }
  ch.a[(t0 + 2 * q) * ch.lda + s] = x[0];
  ch.a[(t0 + 2 * q + 1) * ch.lda + s] = x[1];
}

// A barrier for the first `warps` warps of the block (named barrier 1)
__device__ __forceinline__ void sync_warps(int warps) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(warps * 32) : "memory");
}

// DK: the key head size; NTO / NTU: 8-column tiles a warp holds in the
// outputs / the state
template <int DK, int NTO, int NTU>
__global__ void __launch_bounds__(kThreads, 1) wkv6_fwd_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr int dk = DK;
  const int tv = p.tv, L = p.chunk;
  const int lp = round16(min(L, p.s_len));  // every chunk's padded length
  const int nsub = lp / kSub;
  const Smem lay(lp, dk, tv);
  const int ldk = lay.ldk, ldv = lay.ldv, lda = lay.lda, lds = lay.lds;
  float* sCum = smem + lay.cum;
  float* sU = smem + lay.u;

  const int tid = threadIdx.x;
  // the warp index through a shuffle, so the compiler knows it is the same
  // on every lane: the mma.sync and shuffles under conditions on it are
  // then issued as plain warp instructions, not as divergence-safe loops
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int j0 = blockIdx.x * tv;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool vec4 = p.vec4 != 0;

  const float* rb = p.r + b * p.r_sb + h * p.r_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh + j0;
  const float* wb = p.w + b * p.w_sb + h * p.w_sh;

  // Chunk loads, into one of two stages, by cp.async from the lanes of one
  // warp that has no score job: a copy waits for room among the SM's
  // outstanding loads, so the other warps never issue one
  const int kshift = log2_int(vec4 ? dk / 4 : dk), vshift = log2_int(vec4 ? tv / 4 : tv);
  auto issue_loads = [&](int t0, int stage) {
    const int live = min(L, p.s_len - t0);
    stage_rows(smem + lay.r[stage], ldk, rb + t0 * p.r_ss, p.r_ss, kshift, live, lp, vec4);
    stage_rows(smem + lay.k[stage], ldk, kb + t0 * p.k_ss, p.k_ss, kshift, live, lp, vec4);
    stage_rows(smem + lay.w[stage], ldk, wb + t0 * p.w_ss, p.w_ss, kshift, live, lp, vec4);
    stage_rows(smem + lay.v[stage], ldv, vb + t0 * p.v_ss, p.v_ss, vshift, live, lp, vec4);
    hopper::cp_async_commit();
  };
  constexpr int kLoader = kWarps - 1;
  if (warp == kLoader) issue_loads(0, 0);
  for (int c = tid; c < dk; c += kThreads) sU[c] = p.u[h * dk + c];
  // the upper right 8 x 8 of each diagonal block (s > t) stays 0: no job
  // writes it; so does row -1 of cum
  for (int i = tid; i < lp * lda; i += kThreads) smem[lay.a + i] = 0.f;
  for (int c = tid; c < dk; c += kThreads) sCum[c - ldk] = 0.f;

  // the outputs: warps [wps i, wps i + wps) share sub-chunk i, warp part
  // holding tiles part, part + wps, ...
  const int nts = tv / 8;
  const int wps = out_warps(nsub);
  const int oi = warp / wps, opart = warp % wps;
  const bool o_on = oi < nsub && opart < nts;
  // the state: warps [wpm m, wpm m + wpm) hold rows [16 m, 16 m + 16) of
  // S, warp spart tiles spart, spart + wpm, ..., in the accumulator layout
  const int wpm = state_warps(dk);
  const int smt = warp / wpm, spart = warp % wpm;
  const bool s_on = spart < nts;
  const int c_lo = kSub * smt + g, c_hi = c_lo + 8;
  const bool lo_ok = c_lo < dk, hi_ok = c_hi < dk;
  const long long state_at = (static_cast<long long>(b) * p.h + h) * dk * p.dv + j0;
  float st[NTU][4];
#pragma unroll
  for (int m = 0; m < NTU; ++m) {
    const int nt = spart + wpm * m;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e < 2 ? c_lo : c_hi;
      const int j = 8 * nt + 2 * q + (e & 1);
      const bool own = s_on && c < dk;
      st[m][e] = own && p.s0 ? p.s0[state_at + static_cast<long long>(c) * p.dv + j] : 0.f;
      if (own) smem[lay.s[0] + c * lds + j] = st[m][e];
    }
  }

  int n = 0;
  for (int t0 = 0; t0 < p.s_len; t0 += L, ++n) {
    const int stage = n & 1;
    const int live = min(L, p.s_len - t0);
    float* sR = smem + lay.r[stage];
    float* sK = smem + lay.k[stage];
    float* sW = smem + lay.w[stage];
    const Chunk ch{sR, sK, sW, sCum - ldk, sCum, smem + lay.v[stage], sU, smem + lay.a,
                   ldk, ldv, lda, g, q};
    const float* sS = smem + lay.s[stage];
    float* sSnext = smem + lay.s[stage ^ 1];

    // ---- 1. this chunk's tiles; cum ----
    hopper::cp_async_wait_all();  // the loader's copies; then visible to all
    __syncthreads();
    PHASE_BEGIN();
    {
      // lanes (g, q): row 8 rb + g, channel 4 cg + q; rows past the chunk's
      // end take log w = 0 (cum stays at its last value). cum_prev[t] is
      // read as cum[t - 1], so it equals the stored cum bit for bit
      for (int cg = warp; cg < dk / 4; cg += kWarps) {
        const int c = 4 * cg + q;
        float x[8];
#pragma unroll
        for (int rb8 = 0; rb8 < 8; ++rb8) {
          const int t = 8 * rb8 + g;
          x[rb8] = 0.f;
          if (t < live) {
            const float wf = fmaxf(sW[t * ldk + c], kWFloor);
            sW[t * ldk + c] = wf;
            x[rb8] = fmaxf(log2f(wf), kLog2Floor);
          }
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
#pragma unroll
          for (int rb8 = 0; rb8 < 8; ++rb8) {
            const float y = __shfl_up_sync(kFull, x[rb8], 4 * off);
            if (g >= off) x[rb8] += y;
          }
        }
        float carry = 0.f;  // cum of the row before the block
#pragma unroll
        for (int rb8 = 0; rb8 < 8; ++rb8) {
          const float total = __shfl_sync(kFull, x[rb8], 28 + q);
          const int t = 8 * rb8 + g;
          if (t < lp) sCum[t * ldk + c] = x[rb8] + carry;
          carry += total;
        }
      }
    }
    PHASE_END(0);
    __syncthreads();
    PHASE_RESTART();

    // ---- 2. the loader: the next chunk's copies (into the other stage,
    // whose last readers finished before the barriers above), then straight
    // to the barrier after the decay pass below. The others: scores, three
    // diagonal jobs a sub-chunk on warps [0, 3 nsub), and the off-diagonal
    // ones, sub-chunk i having i of them, round robin on the warps after
    // those; then the decay pass ----
    if (warp == kLoader) {
      if (t0 + L < p.s_len) issue_loads(t0 + L, stage ^ 1);
    } else {
      const int n_diag = 3 * nsub, n_off = nsub * (nsub - 1) / 2;
      if (warp < n_diag) {
        const int i = warp / 3, kind = warp - 3 * i;
        diagonal<DK>(ch, i, kind == 0 ? 0 : 8, kind == 2 ? 8 : 0);
      }
      const int first = n_diag < kLoader ? n_diag : 0;  // warps taking off-diagonal jobs
      for (int job = warp - first; job >= 0 && job < n_off; job += kLoader - first) {
        int i = 1, jp = job;
        while (jp >= i) {
          jp -= i;
          ++i;
        }
        off_diagonal<DK>(ch, i, jp);
      }
    }
    PHASE_END(1);
    if (warp != kLoader) {
      sync_warps(kLoader);  // the scores read r and k as they were
      PHASE_RESTART();
      // ---- 3. r decayed back to the chunk's start and k to its end, in
      // place; outputs; the state ----
      const float* last = sCum + (lp - 1) * ldk;
      for (int idx = tid; idx < lp * dk; idx += kLoader * 32) {
        const int t = idx / dk, c = idx - t * dk;
        sR[t * ldk + c] *= decay2(ch.prev[t * ldk + c]);
        sK[t * ldk + c] *= decay2(last[c] - sCum[t * ldk + c]);
      }
      PHASE_END(2);
    }
    __syncthreads();
    PHASE_RESTART();
    if (o_on) {
      const int i = oi;
      const int t_lo = kSub * i + g, t_hi = t_lo + 8;
      // two accumulator sets, even and odd steps, halve the tensor-core chains
      float db[2][NTO][4] = {}, ds[2][NTO][4] = {};
#pragma unroll
      for (int kc = 0; kc < DK / 8; ++kc) {
        const int ca = 8 * kc + q, cb = ca + 4, e = kc & 1;
        FragA a;
        a.set(0, sR[t_lo * ldk + ca]);
        a.set(1, sR[t_hi * ldk + ca]);
        a.set(2, sR[t_lo * ldk + cb]);
        a.set(3, sR[t_hi * ldk + cb]);
#pragma unroll
        for (int m = 0; m < NTO; ++m) {
          const int col = 8 * (opart + wps * m) + g;
          FragB bf;
          bf.set(0, sS[ca * lds + col]);
          bf.set(1, sS[cb * lds + col]);
          mma3(db[e][m], ds[e][m], a, bf);
        }
      }
#pragma unroll 2
      for (int ks2 = 0; ks2 < 2 * (i + 1); ks2 += 2) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 8 * (ks2 + e) + 2 * q;  // time rows s, s + 1 for k = q, q + 4
          const float2 lo = load2(ch.a + t_lo * lda + s);
          const float2 hi = load2(ch.a + t_hi * lda + s);
          FragA a;
          a.set(0, lo.x);
          a.set(1, hi.x);
          a.set(2, lo.y);
          a.set(3, hi.y);
#pragma unroll
          for (int m = 0; m < NTO; ++m) {
            const int col = 8 * (opart + wps * m) + g;
            FragB bf;
            bf.set(0, ch.v[s * ldv + col]);
            bf.set(1, ch.v[(s + 1) * ldv + col]);
            mma3(db[e][m], ds[e][m], a, bf);
          }
        }
      }
      const long long row_lo = (static_cast<long long>(b) * p.s_len + t0 + t_lo) * p.h + h;
      const long long row_hi = row_lo + 8LL * p.h;
#pragma unroll
      for (int m = 0; m < NTO; ++m) {
        float x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = (ds[0][m][j] + ds[1][m][j]) + (db[0][m][j] + db[1][m][j]);
        const int j = j0 + 8 * (opart + wps * m) + 2 * q;
        if (t_lo < live) store2(p.o + row_lo * p.dv + j, x[0], x[1]);
        if (t_hi < live) store2(p.o + row_hi * p.dv + j, x[2], x[3]);
      }
    }
    PHASE_END(3);
    PHASE_RESTART();
    if (s_on) {
      // S' = e^{cum_last} S + (k e^{cum_last - cum})^T V
      const float* last = sCum + (lp - 1) * ldk;
      const float last_lo = lo_ok ? last[c_lo] : 0.f;
      const float last_hi = hi_ok ? last[c_hi] : 0.f;
      float db[2][NTU][4] = {}, ds[2][NTU][4] = {};
#pragma unroll 2
      for (int ks2 = 0; ks2 < lp / 8; ks2 += 2) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * (ks2 + e) + 2 * q;  // time rows t, t + 1 for k = q, q + 4
          FragA a;
          a.set(0, lo_ok ? sK[t * ldk + c_lo] : 0.f);
          a.set(1, hi_ok ? sK[t * ldk + c_hi] : 0.f);
          a.set(2, lo_ok ? sK[(t + 1) * ldk + c_lo] : 0.f);
          a.set(3, hi_ok ? sK[(t + 1) * ldk + c_hi] : 0.f);
#pragma unroll
          for (int m = 0; m < NTU; ++m) {
            const int col = 8 * (spart + wpm * m) + g;
            FragB bf;
            bf.set(0, ch.v[t * ldv + col]);
            bf.set(1, ch.v[(t + 1) * ldv + col]);
            mma3(db[e][m], ds[e][m], a, bf);
          }
        }
      }
      const float d_lo = decay2(last_lo), d_hi = decay2(last_hi);
#pragma unroll
      for (int m = 0; m < NTU; ++m) {
        float x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = (ds[0][m][j] + ds[1][m][j]) + (db[0][m][j] + db[1][m][j]);
        st[m][0] = fmaf(d_lo, st[m][0], x[0]);
        st[m][1] = fmaf(d_lo, st[m][1], x[1]);
        st[m][2] = fmaf(d_hi, st[m][2], x[2]);
        st[m][3] = fmaf(d_hi, st[m][3], x[3]);
        const int j = 8 * (spart + wpm * m) + 2 * q;
        if (lo_ok) store2(sSnext + c_lo * lds + j, st[m][0], st[m][1]);
        if (hi_ok) store2(sSnext + c_hi * lds + j, st[m][2], st[m][3]);
      }
    }
    PHASE_END(4);
  }

  if (s_on) {
#pragma unroll
    for (int m = 0; m < NTU; ++m) {
      const int j = 8 * (spart + wpm * m) + 2 * q;
      float* out = p.state + state_at + j;
      if (lo_ok) store2(out + static_cast<long long>(c_lo) * p.dv, st[m][0], st[m][1]);
      if (hi_ok) store2(out + static_cast<long long>(c_hi) * p.dv, st[m][2], st[m][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using Kernel = void (*)(const Params);

// By key head size, then tiles a warp holds (outputs, state); the state
// of a head of 32 or fewer keys is spread over enough warps for one tile.
const Kernel kKernels[4][2][2] = {
    {{wkv6_fwd_kernel<8, 1, 1>, nullptr}, {wkv6_fwd_kernel<8, 2, 1>, nullptr}},
    {{wkv6_fwd_kernel<16, 1, 1>, nullptr}, {wkv6_fwd_kernel<16, 2, 1>, nullptr}},
    {{wkv6_fwd_kernel<32, 1, 1>, nullptr}, {wkv6_fwd_kernel<32, 2, 1>, nullptr}},
    {{wkv6_fwd_kernel<64, 1, 1>, wkv6_fwd_kernel<64, 1, 2>},
     {wkv6_fwd_kernel<64, 2, 1>, wkv6_fwd_kernel<64, 2, 2>}},
};

// cudaFuncSetAttribute for the kernels' largest dynamic shared memory,
// once per device (a bit of `done` each).
std::atomic<uint64_t> g_smem_done{0};

cudaError_t set_smem_once(int device) {
  const uint64_t bit = 1ull << (device & 63);
  if (g_smem_done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const int bytes = Smem(kMaxChunk, kMaxDim, kMaxDim).total * static_cast<int>(sizeof(float));
  for (const auto& by_dk : kKernels)
    for (const auto& row : by_dk)
      for (Kernel kernel : row) {
        if (kernel == nullptr) continue;
        const cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
      }
  g_smem_done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

// The device's SM count, read once per device.
int sm_count(int device) {
  static std::atomic<int> counts[64];
  int n = counts[device & 63].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      n = 1;
    counts[device & 63].store(n, std::memory_order_relaxed);
  }
  return n;
}

bool head_size_ok(int d) { return d == 8 || d == 16 || d == 32 || d == 64; }

bool aligned16(const void* ptr, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 && ss % 4 == 0 &&
         sh % 4 == 0;
}

}  // namespace

#ifdef WKV6_PHASE_CYCLES
// Copies the phase counters (kPhases x kWarps) to `out` and zeroes them.
extern "C" int wkv6_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zeros[kPhases][kWarps] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof(zeros)));
}
#endif

// As wkv6_fwd, with the state columns a block chosen by the caller:
// column_tile = dv (the whole head), dv / 2 (two blocks a head, each
// computing the scores), or 0 for the kernel's own choice (two tiles when
// one a head would fill at most half the SMs).
extern "C" int wkv6_fwd_tiled(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* o, void* state,
                              int b, int s, int h, int dk, int dv, int chunk,
                              long long r_sb, long long r_ss, long long r_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long w_sb, long long w_ss, long long w_sh,
                              int column_tile, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || h <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (chunk < 1 || chunk > kMaxChunk || !head_size_ok(dk) || !head_size_ok(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  int tv = column_tile;
  if (tv == 0) tv = dv >= 16 && 2 * b * h <= sm_count(device) ? dv / 2 : dv;
  if (!(tv == dv || (tv == dv / 2 && dv >= 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  err = set_smem_once(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a chunk of `chunk` steps is taken as one of round16(chunk): the closed
  // form holds for any length, and the kernel's tiles are 16 rows
  chunk = round16(chunk);
  const int lp = round16(chunk < s ? chunk : s);
  const size_t smem = Smem(lp, dk, tv).total * sizeof(float);
  const int vec4 = aligned16(r, r_sb, r_ss, r_sh) && aligned16(k, k_sb, k_ss, k_sh) &&
                   aligned16(v, v_sb, v_ss, v_sh) && aligned16(w, w_sb, w_ss, w_sh);
  const Params p{static_cast<const float*>(r), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(w),
                 static_cast<const float*>(u), static_cast<const float*>(s0),
                 static_cast<float*>(o), static_cast<float*>(state),
                 s, h, dk, dv, chunk, tv, vec4,
                 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh};
  const int nts = tv / 8, nsub = lp / kSub;
  const int dk_index = dk == 8 ? 0 : dk == 16 ? 1 : dk == 32 ? 2 : 3;
  const Kernel kernel = kKernels[dk_index][tiles_a_warp(nts, out_warps(nsub)) - 1]
                                [tiles_a_warp(nts, state_warps(dk)) - 1];
  const dim3 grid(dv / tv, h, b);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// r/k/v/w strides are (batch, seq, head) in elements; the last dim is
// contiguous. u is (h, dk) contiguous; s0 (b, h, dk, dv) contiguous, or
// null for a zero initial state; o (b, s, h, dv) and state (b, h, dk, dv)
// are written contiguous. All fp32. Needs 1 <= chunk <= 64 (the last
// chunk takes what is left of s) and dk, dv in {8, 16, 32, 64}.
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
  return wkv6_fwd_tiled(r, k, v, w, u, s0, o, state, b, s, h, dk, dv, chunk, r_sb, r_ss,
                        r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh, 0,
                        device, stream);
}
