// Flash attention backward for Hopper (sm_90a): the gradient of the
// forward kernel in flash_attention.cu.
//
// The Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py has no backward: the JAX
// package trains through its jnp attention. The port's dense trunk runs
// attention through its CUDA kernel, so its gradient is a kernel too. It
// follows FlashAttention-2: the probabilities are recomputed from the
// forward's log-sum-exp, never stored.
//
//   S = scale q k^T,  P = exp(S - lse)  (P = 0 where masked or lse = -inf)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),  D = rowsum(dO O)
//   dQ = scale dS K,  dK = scale dS^T Q
//
// with the forward's masks: causal with a query offset, a sliding window,
// keys past sk, and whole tiles outside the band skipped. GQA: query head
// h reads kv head h / n_rep.
//
// Bound on the H100: operations (five products of s^2 d a head against
// ~8 s d elements moved). No atomic operation on the device (the one
// `std::atomic` is the host's once-a-device flag for the shared-memory
// attribute), so two calls give the same bits. Three routes, chosen by
// dtype and head size only (never because another failed);
// kernels/flash_attention/ops.py mirrors the choice (`bwd_route`) and the
// launch plan (`bwd_plan`), which the two tensor-core routes share:
//
// * bf16, d in {64, 128, 256}: the tensor-core kernels, four launches.
//   (a) `flash_bwd_stats_kernel`: D in fp32, one warp a (batch, head,
//       query) row, written with the lse in log2 units into a layout of
//       one 512-byte record a 64-query tile, padded past sq.
//   (b) `flash_bwd_dkdv_kernel_wgmma`: a block holds a 64-key tile of K
//       and V in shared memory (TMA, 128-byte swizzle) and streams the
//       query tiles of the band through a TMA ring of two stages: Q, dO
//       and the tile's statistics record (one bulk copy), so no step
//       waits on a global load. Keys are the wgmma M: S^T = K Q^T and
//       dP^T = V dO^T are m64n64k16 with K-major operands (the forward's
//       call with the roles swapped); P^T = exp2(S^T scale log2 e - lse),
//       with lse = -inf and the padding stored as +inf, so such a query
//       gives P = 0 and exp2 never sees +inf. Rounded to bf16 in
//       registers, P^T and dS^T = P^T (dP^T - D) already are the A
//       fragments of dV += P^T dO and dK += dS^T Q, with dO and Q
//       MN-major through the transpose bit: no shared-memory transpose.
//       At d <= 128 one warpgroup runs all four products (S^T and dP^T as
//       two commit groups, P^T formed while dP^T finishes, dV issued while
//       dS^T is formed), two blocks an SM (241 registers at d = 128, 98
//       KB of shared memory). At d = 256 dK plus dV would need 256 fp32
//       registers a thread, so two warpgroups split the work: warpgroup 0
//       computes S^T, P^T and dV, warpgroup 1 dP^T, dS^T and dK, with P^T
//       handed over through 16 KB of shared memory in the accumulator's
//       own thread order (a named barrier); 218 registers, 210 KB.
//       The launch fills the card (`bwd_plan`): under the causal mask a
//       block takes key tiles p and n - 1 - p, so every block walks
//       about n + 1 query tiles; and the group's query heads are split
//       over `splits` blocks when b x hkv x tiles is under 128 blocks
//       (gemma-2b's single kv head: 32 pairs x 4 splits at (1, 4096)).
//       With splits > 1 each block writes fp32 partial dK and dV
//       (splits, b, sk, hkv, d) into scratch the wrapper allocates.
//   (c) `flash_bwd_sum_kernel` (splits > 1 only): dK and dV as the sum
//       of the partials in split order 0, 1, ..., in bf16.
//   (d) `flash_bwd_dq_kernel_wgmma`: one warpgroup a 64-query tile of one
//       head, Q and dO resident, K and V through a TMA ring of two
//       stages: S = Q K^T and dP = dO V^T (K-major, two commit groups, P
//       computed while dP finishes), dS rounded to bf16 in registers,
//       dQ += dS K with K MN-major. Longest causal query tiles first.
//       dQ is recomputed from S and dP rather than summed across key
//       tiles in the dK/dV pass: seven products where five would do,
//       since that sum needs atomics or a partial per key tile (2 GiB
//       at gemma-2b's (1, 4096)).
//   Masks are applied only on tiles that cross an edge; TMA's zero fill
//   covers rows past sq and sk, and stores are masked.
// * fp32, d in {64, 128, 256} (held to 1e-5, which bf16 products cannot
//   meet): 3xTF32 `mma.sync` (m16n8k8; each fp32 operand split into two
//   TF32 parts, big*big + big*small + small*big accumulated in fp32, as
//   wkv6.cu does), the same four launches on the same plan: the stats
//   kernel (the lse in natural units, since P = exp(S scale - lse) as the
//   fp32 forward's lse and the SIMT route have it), a dK/dV pass, the
//   split sum in fp32 and a dQ pass. wgmma's tf32 form needs both operands
//   K-major, so P^T dO, dS^T Q and dS K would need transposed tiles;
//   mma.sync takes them as they lie. Tiles are staged in fp32 in shared
//   memory by cp.async, two stages deep, rows padded to d + 4 floats so
//   every fragment load is free of bank conflicts. The register budget: a
//   block is two warpgroups (256 threads) at every d, and warp w of each
//   shares 16 keys (dK/dV pass) or 16 queries (dQ pass). In the dK/dV pass
//   warp w of warpgroup 0 computes S^T, P^T and dV, warp w of warpgroup 1
//   dP^T, dS^T and dK, P^T handed over in shared memory in the
//   accumulator's thread order, each holding d / 2 accumulator registers
//   for its keys. At d = 256 those 128 beside the products' fragments
//   spilled, so there two warps of a warpgroup share 16 keys and split d:
//   each computes its half of S^T (dP^T), the halves are exchanged through
//   shared memory and summed in column order (both warps hold the same
//   bits), and each accumulates its half of dV's (dK's) columns; a walk
//   of the band then covers 32 keys, and the band is walked twice. In the
//   dQ pass warpgroup 0 forms P, warpgroup 1 dS, handed back, and each
//   accumulates half of dQ's columns. The products'
//   inner index over queries (keys) is taken in the order the accumulator
//   holds them, so P^T and dS^T (dS) go from accumulator registers
//   straight into A fragments. Each mma chain spans at most 32 inner rows
//   and is then added to its accumulator by fp32 adds: the tensor cores'
//   accumulation does not round to nearest, and one chain over a (1,
//   4096) band missed 1e-5. A step streams 64 queries (keys) at d = 64, 32
//   at d = 128 and 16 at d = 256, so a step's score tiles stay in
//   registers (and the resident 64-row fp32 tiles take 130 KB at d = 256).
// * d in {16, 32} (smoke widths only), fp32 and bf16: the SIMT fp32
//   kernels, three launches: D; `flash_bwd_dkdv_kernel`, one block per
//   (key tile, kv head, batch) that loops over the group's query heads
//   and the band's query tiles, so the GQA sum stays inside the block;
//   `flash_bwd_dq_kernel`, one block per (query tile, query head,
//   batch). Tiles staged as fp32 in shared memory, each of 256 threads
//   computes a patch of each product (64 x 64 tiles); bound by
//   shared-memory reads.
//
// Layout: q, o, dO, dq (b, sq, hq, d); k, v, dk, dv (b, sk, hkv, d); all
// contiguous: the wrapper copies a strided view (a copy of b s h d
// elements each, none on the training path, whose q, k, v and dO are
// contiguous already), and builds the tensor maps of the copies. lse and
// D are fp32 (b, hq, sq). Gradients are written in the inputs' dtype.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (src/repro_torch/kernels/flash_attention/ops.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid over each tile product

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Query rows (BQ) and keys (BK) a tile of the SIMT route (d 16 and 32).
template <int D>
struct Tile {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
  static constexpr int LD = D + 1;   // padded row of a q/k/v/dO tile
  static constexpr int LS = BK + 1;  // padded row of a P / dS tile
  // sQ, sdO (BQ x LD), sK, sV (BK x LD), sP, sdS (BQ x LS), lse and D (BQ)
  static constexpr size_t smem_bytes =
      sizeof(float) * (2 * BQ * LD + 2 * BK * LD + 2 * BQ * LS + 2 * BQ);
};

// Rows r0 .. r0 + R - 1 of one head of a (b, s, h, D) tensor into a padded
// fp32 tile; rows past n are zero. `base` points at (batch, row 0, head).
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ base,
                                          int r0, int n, int64_t row_stride) {
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    dst[r * (D + 1) + c] =
        r0 + r < n ? to_f32(base[static_cast<int64_t>(r0 + r) * row_stride + c]) : 0.f;
  }
}

// lse and D of query rows q0 .. q0 + BQ - 1 of row block `rows` (b, h);
// rows past sq get lse = -inf, so their P is 0.
template <int BQ>
__device__ __forceinline__ void load_stats(float* sLse, float* sDv,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ dvec, int q0,
                                           int sq) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < sq;
    sLse[r] = in ? lse[q0 + r] : -INFINITY;
    sDv[r] = in ? dvec[q0 + r] : 0.f;
  }
}

// P and dS of one (query tile, key tile) pair from the staged tiles: each
// thread computes rows ty * RQ .. + RQ - 1 and columns tx + 16 j of S and
// dP over d, then writes P and dS = P (dP - D) to shared memory.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* sQ, const float* sdO,
                                         const float* sK, const float* sV,
                                         const float* sLse, const float* sDv,
                                         float* sP, float* sdS, int q0, int k0,
                                         int sq, int sk, float scale, int causal,
                                         int window, int q_offset) {
  using Tl = Tile<D>;
  constexpr int RQ = Tl::BQ / 16;
  constexpr int RK = Tl::BK / 16;
  constexpr int LD = Tl::LD;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  float s[RQ][RK], dp[RQ][RK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qv[RQ], ov[RQ], kv[RK], vv[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = sQ[(ty * RQ + i) * LD + c];
      ov[i] = sdO[(ty * RQ + i) * LD + c];
    }
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      kv[j] = sK[(tx + 16 * j) * LD + c];
      vv[j] = sV[(tx + 16 * j) * LD + c];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    const int qr = q0 + r;
    const int qa = qr + q_offset;
    const float l = sLse[r];
    const float dv = sDv[r];
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int col = tx + 16 * j;
      const int ka = k0 + col;
      bool ok = qr < sq && ka < sk && l != -INFINITY;
      if (causal) ok = ok && qa >= ka;
      if (window > 0) ok = ok && ka > qa - window;
      const float p = ok ? expf(s[i][j] * scale - l) : 0.f;
      sP[r * Tl::LS + col] = p;
      sdS[r * Tl::LS + col] = p * (dp[i][j] - dv);
    }
  }
}

// (a) D = rowsum(dO O) in fp32, one warp a (batch, query, head) row, into
// (b, hq, sq).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ dvec, int64_t rows, int sq, int hq, int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + row * d;
  const T* grow = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(grow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % hq);
    const int64_t bs = row / hq;  // b * sq + s
    const int s = static_cast<int>(bs % sq);
    const int64_t b = bs / sq;
    dvec[(b * hq + h) * sq + s] = acc;
  }
}

// (b) dK and dV of one key tile of one kv head, summed over the group's
// query heads and the query tiles that see the tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dvec,
                      T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int hq,
                      int hkv, float scale, int causal, int window, int q_offset) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::BQ;
  constexpr int BK = Tl::BK;
  constexpr int LD = Tl::LD;
  constexpr int LS = Tl::LS;
  constexpr int RK = BK / 16;  // key rows a thread accumulates
  constexpr int NC = D / 16;   // columns of d a thread accumulates
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sdS = sP + BQ * LS;
  float* sLse = sdS + BQ * LS;
  float* sDv = sLse + BQ;

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = hq / hkv;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t q_row = static_cast<int64_t>(hq) * D;
  const int64_t kv_row = static_cast<int64_t>(hkv) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * sk * kv_row + static_cast<int64_t>(hk) * D;

  load_rows<T, D, BK>(sK, k + kv_off, k0, sk, kv_row);
  load_rows<T, D, BK>(sV, v + kv_off, k0, sk, kv_row);

  // query rows that see a key of this tile: [q_lo, q_hi)
  const int k_last = min(k0 + BK, sk) - 1;
  int q_lo = 0;
  int q_hi = sq;
  if (causal) q_lo = max(q_lo, k0 - q_offset);
  if (window > 0) q_hi = min(q_hi, k_last + window - q_offset);

  float dk_acc[RK][NC], dv_acc[RK][NC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  for (int hr = 0; hr < n_rep && q_lo < q_hi; ++hr) {
    const int h = hk * n_rep + hr;
    const int64_t q_off = static_cast<int64_t>(b) * sq * q_row + static_cast<int64_t>(h) * D;
    const int64_t stat_off = (static_cast<int64_t>(b) * hq + h) * sq;
    for (int q0 = (q_lo / BQ) * BQ; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, D, BQ>(sQ, q + q_off, q0, sq, q_row);
      load_rows<T, D, BQ>(sdO, dout + q_off, q0, sq, q_row);
      load_stats<BQ>(sLse, sDv, lse + stat_off, dvec + stat_off, q0, sq);
      __syncthreads();
      p_and_ds<D>(sQ, sdO, sK, sV, sLse, sDv, sP, sdS, q0, k0, sq, sk, scale, causal,
                  window, q_offset);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: key rows ty * RK + i, columns tx + 16 c
#pragma unroll 2
      for (int j = 0; j < BQ; ++j) {
        float p[RK], ds[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          p[i] = sP[j * LS + ty * RK + i];
          ds[i] = sdS[j * LS + ty * RK + i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float go = sdO[j * LD + tx + 16 * c];
          const float qv = sQ[j * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            dv_acc[i][c] = fmaf(p[i], go, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kr = k0 + ty * RK + i;
    if (kr >= sk) continue;
    const int64_t off = kv_off + static_cast<int64_t>(kr) * kv_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c] * scale);
      dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// (c) dQ of one query tile of one query head, over the key tiles of the
// band.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    T* __restrict__ dq, int sq, int sk, int hq, int hkv, float scale,
                    int causal, int window, int q_offset) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::BQ;
  constexpr int BK = Tl::BK;
  constexpr int LD = Tl::LD;
  constexpr int LS = Tl::LS;
  constexpr int RQ = BQ / 16;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sdS = sP + BQ * LS;
  float* sLse = sdS + BQ * LS;
  float* sDv = sLse + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int64_t q_row = static_cast<int64_t>(hq) * D;
  const int64_t kv_row = static_cast<int64_t>(hkv) * D;
  const int64_t q_off = static_cast<int64_t>(b) * sq * q_row + static_cast<int64_t>(h) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * sk * kv_row + static_cast<int64_t>(hk) * D;
  const int64_t stat_off = (static_cast<int64_t>(b) * hq + h) * sq;

  load_rows<T, D, BQ>(sQ, q + q_off, q0, sq, q_row);
  load_rows<T, D, BQ>(sdO, dout + q_off, q0, sq, q_row);
  load_stats<BQ>(sLse, sDv, lse + stat_off, dvec + stat_off, q0, sq);

  // keys this query tile sees: [k_lo, k_hi), as the forward's band
  const int qa_first = q0 + q_offset;
  const int qa_last = min(q0 + BQ, sq) - 1 + q_offset;
  int k_lo = 0;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, qa_last + 1);
  if (window > 0) k_lo = max(k_lo, qa_first - window + 1);

  float dq_acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D, BK>(sK, k + kv_off, k0, sk, kv_row);
    load_rows<T, D, BK>(sV, v + kv_off, k0, sk, kv_row);
    __syncthreads();
    p_and_ds<D>(sQ, sdO, sK, sV, sLse, sDv, sP, sdS, q0, k0, sq, sk, scale, causal,
                window, q_offset);
    __syncthreads();
    // dQ += dS K: query rows ty * RQ + i, columns tx + 16 c
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float ds[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ds[i] = sdS[(ty * RQ + i) * LS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sK[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) dq_acc[i][c] = fmaf(ds[i], kv, dq_acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qr = q0 + ty * RQ + i;
    if (qr >= sq) continue;
    const int64_t off = q_off + static_cast<int64_t>(qr) * q_row;
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[off + tx + 16 * c] = from_f32<T>(dq_acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core route
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;           // one warpgroup
constexpr int kTile = 64;                 // queries or keys a tile (the wgmma M and N)
constexpr uint32_t kBoxBytes = 64 * 128;  // one TMA box: 64 rows of 64 bf16
constexpr int kStages = 2;                // ring depth
constexpr int kBarP = 1;                  // named barrier: P^T handed to warpgroup 1
constexpr float kLog2e = 1.4426950408889634f;

// Tiles [lo, hi) of a band, the same arithmetic as the forward's.
struct Band {
  int lo;
  int hi;
  __device__ __forceinline__ int size() const { return hi > lo ? hi - lo : 0; }
};

// Key tiles a query tile [q0, q0 + 64) sees.
__device__ __forceinline__ Band key_band(int q0, int sq, int sk, int causal, int window,
                                         int q_offset) {
  const int qa_first = q0 + q_offset;
  const int qa_last = min(q0 + kTile, sq) - 1 + q_offset;
  int k_lo = 0;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, qa_last + 1);
  if (window > 0) k_lo = max(k_lo, qa_first - window + 1);
  return {k_lo / kTile, k_hi > k_lo ? (k_hi + kTile - 1) / kTile : 0};
}

// Query tiles that see a key tile [k0, k0 + 64).
__device__ __forceinline__ Band query_band(int k0, int sq, int sk, int causal, int window,
                                           int q_offset) {
  const int k_last = min(k0 + kTile, sk) - 1;
  int q_lo = 0;
  int q_hi = sq;
  if (causal) q_lo = max(q_lo, k0 - q_offset);
  if (window > 0) q_hi = min(q_hi, k_last + window - q_offset);
  return {q_lo / kTile, q_hi > q_lo ? (q_hi + kTile - 1) / kTile : 0};
}

// Does the pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) cross
// an edge of the mask or of sk?
__device__ __forceinline__ bool crosses_edge(int q0, int nq, int k0, int nk, int sq, int sk,
                                             int causal, int window, int q_offset) {
  const int qa_first = q0 + q_offset;
  const int qa_last = min(q0 + nq, sq) - 1 + q_offset;
  return (k0 + nk > sk) || (causal && k0 + nk - 1 > qa_first) ||
         (window > 0 && k0 <= qa_last - window);
}

__device__ __forceinline__ bool pair_valid(int qa, int ka, int sk, int causal, int window) {
  bool ok = ka < sk;
  if (causal) ok = ok && qa >= ka;
  if (window > 0) ok = ok && ka > qa - window;
  return ok;
}

// The per-query statistics of the tensor-core routes, (b, hq, n_qt, 2, 64)
// fp32: for each 64-query tile, lse (in log2 units on the bf16 route,
// natural on the fp32 one), then D. An lse of -inf (no valid key) and the
// padding past sq are stored as +inf, so exp2(s - lse) (or exp) is 0 for
// every s and never of +inf; the padding's D is 0. On the bf16 route one
// tile's 512 bytes arrive with its Q and dO by one bulk copy.
constexpr int kStatFloats = 2 * kTile;

// (a) D = rowsum(dO O) and the lse (in log2 units if kLog2), one warp a
// (batch, head, padded query) row.
template <typename T, bool kLog2>
__global__ void __launch_bounds__(kThreads)
flash_bwd_stats_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ stats,
                       int64_t rows, int sq, int n_qt, int hq, int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const int sp = static_cast<int>(row % (static_cast<int64_t>(n_qt) * kTile));
  const int64_t bh = row / (static_cast<int64_t>(n_qt) * kTile);  // b * hq + h
  float acc = 0.f;
  if (sp < sq) {
    const int64_t off = ((bh / hq * sq + sp) * hq + bh % hq) * d;
    for (int c = lane; c < d; c += 32)
      acc = fmaf(to_f32(o[off + c]), to_f32(dout[off + c]), acc);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  }
  if (lane == 0) {
    const float l = sp < sq ? lse[bh * sq + sp] : -INFINITY;
    float* tile = stats + (bh * n_qt + sp / kTile) * kStatFloats;
    tile[sp % kTile] = l == -INFINITY ? INFINITY : kLog2 ? l * kLog2e : l;
    tile[kTile + sp % kTile] = acc;
  }
}

// Warpgroups of a dK/dV block: two at d = 256, where one warpgroup cannot
// hold both d-wide fp32 accumulators (256 registers a thread); one below,
// which keeps two blocks an SM.
template <int D>
constexpr int kDkdvWarpgroups = D == 256 ? 2 : 1;

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, V and kStages x (Q, dO), D / 64 boxes each; kStages x one tile's
  // statistics; with two warpgroups the P^T exchange (64 x 64 fp32); the
  // barriers (K/V, one a stage); 1 KB of slack to put the tiles on the
  // 1024-byte swizzle boundary
  return 1024 + static_cast<size_t>(2 + 2 * kStages) * (D / 64) * kBoxBytes +
         sizeof(float) * kStages * kStatFloats +
         (kDkdvWarpgroups<D> == 2 ? sizeof(float) * kTile * kTile : 0) +
         8 * (1 + kStages);
}

// An accumulator tile (rows: keys r_lo and r_lo + 8; 8-column groups of
// d) times `mult`: bf16 into dst (row stride rs elements) or fp32 into the
// partials; rows past sk are not written.
template <int NC, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[NC][32], T* dst, int64_t rs,
                                           int r0, int r_lo, int cq, int sk, float mult) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kr = r0 + r_lo + 8 * hr;
    if (kr >= sk) continue;
    T* row = dst + kr * rs;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int i = 4 * i8 + 2 * hr;
        const float x = acc[c][i] * mult;
        const float y = acc[c][i + 1] * mult;
        if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float2*>(row + c * 64 + 8 * i8 + cq) = make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(row + c * 64 + 8 * i8 + cq) = hopper::pack_bf16(x, y);
      }
  }
}

// (b) dK and dV of one or two key tiles of one kv head, summed over a
// split of the group's query heads and the query tiles of the band. Two
// warpgroups (d = 256): warpgroup 0 S^T, P^T, dV; warpgroup 1 dP^T, dS^T,
// dK. One warpgroup: all four products.
template <int D>
__global__ void __launch_bounds__(kDkdvWarpgroups<D> * kWgThreads, 3 - kDkdvWarpgroups<D>)
flash_bwd_dkdv_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ stats,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            float* __restrict__ part, int nb, int sq, int sk, int hq,
                            int hkv, int n_kt, int splits, int paired, float scale,
                            float scale_log2, int causal, int window, int q_offset) {
  constexpr int NWG = kDkdvWarpgroups<D>;
  constexpr int NC = D / 64;  // 64-wide column chunks of d (one box each)
  constexpr uint32_t kTileBytes = NC * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + kTileBytes;
  auto sQ = [&](int s) { return sK + (2u + 2u * s) * kTileBytes; };
  auto sdO = [&](int s) { return sQ(s) + kTileBytes; };
  auto sSt = [&](int s) {  // the stage's query statistics
    return sK + (2u + 2u * kStages) * kTileBytes + sizeof(float) * kStatFloats * s;
  };
  const uint32_t sX = sSt(kStages);  // P^T exchange (NWG = 2)
  auto generic = [&](uint32_t a) {
    return reinterpret_cast<const float*>(smem_raw + (a - hopper::smem_addr(smem_raw)));
  };
  float* xbuf = const_cast<float*>(generic(sX));
  const uint32_t bar_kv = sX + (NWG == 2 ? sizeof(float) * kTile * kTile : 0);
  auto bar_qdo = [&](int s) { return bar_kv + 8u * (1 + s); };

  const int tid = threadIdx.x;
  const int wg = tid / kWgThreads;  // NWG = 2: 0 S, P, dV; 1 dP, dS, dK
  const int wtid = tid % kWgThreads;
  const int warp = wtid >> 5;
  const int lane = wtid & 31;
  const int p = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z / hkv;
  const int hk = blockIdx.z % hkv;
  const int n_rep = hq / hkv;
  const int heads = n_rep / splits;  // query heads this block sums over
  const int h0 = hk * n_rep + g * heads;
  const int n_mine = paired && n_kt - 1 - p != p ? 2 : 1;
  const int n_qt = (sq + kTile - 1) / kTile;

  if (tid == 0) {
    hopper::mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(bar_qdo(s), 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // this thread's accumulator rows (keys) r_lo and r_lo + 8 of the tile;
  // in each 8-column group (queries, or columns of d) cq and cq + 1
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);

  int step = 0;  // Q/dO tiles consumed by this block so far: the ring's phase
  for (int t = 0; t < n_mine; ++t) {
    const int kt = t == 0 ? p : n_kt - 1 - p;
    const int k0 = kt * kTile;
    const Band qb = query_band(k0, sq, sk, causal, window, q_offset);
    const int n_q = qb.size();
    const int n_steps = heads * n_q;
    auto load_qdo = [&](int stage, int j) {
      const int h = h0 + j / n_q;
      const int qt = qb.lo + j % n_q;
      const int q0 = qt * kTile;
      constexpr uint32_t kStatBytes = sizeof(float) * kStatFloats;
      hopper::mbar_arrive_expect_tx(bar_qdo(stage), 2 * kTileBytes + kStatBytes);
      hopper::bulk_load(sSt(stage),
                        stats + ((static_cast<int64_t>(b) * hq + h) * n_qt + qt) * kStatFloats,
                        kStatBytes, bar_qdo(stage));
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        hopper::tma_load_4d(sQ(stage) + c * kBoxBytes, &tm_q, bar_qdo(stage), c * 64, h,
                            q0, b);
        hopper::tma_load_4d(sdO(stage) + c * kBoxBytes, &tm_do, bar_qdo(stage), c * 64, h,
                            q0, b);
      }
    };
    __syncthreads();  // every thread is past the previous key tile's waits
    if (tid == 0) {
      hopper::mbar_arrive_expect_tx(bar_kv, 2 * kTileBytes);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        hopper::tma_load_4d(sK + c * kBoxBytes, &tm_k, bar_kv, c * 64, hk, k0, b);
        hopper::tma_load_4d(sV + c * kBoxBytes, &tm_v, bar_kv, c * 64, hk, k0, b);
      }
      for (int s = 0; s < kStages && s < n_steps; ++s) load_qdo((step + s) % kStages, s);
    }

    // NWG = 2: acc is dV (warpgroup 0) or dK (warpgroup 1); NWG = 1: acc
    // is dV and acc2 dK
    float acc[NC][32];
    float acc2[NWG == 1 ? NC : 1][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
    for (int c = 0; c < (NWG == 1 ? NC : 1); ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc2[c][i] = 0.f;
    hopper::mbar_wait(bar_kv, t & 1);

    for (int j = 0; j < n_steps; ++j, ++step) {
      const int stage = step % kStages;
      const uint32_t parity = (step / kStages) & 1;
      const int q0 = (qb.lo + j % n_q) * kTile;
      const float* st = generic(sSt(stage));  // lse (log2 units), then D
      const bool edge = crosses_edge(q0, kTile, k0, kTile, sq, sk, causal, window, q_offset);
      // element i's query (column) within the tile
      auto col = [&](int i) { return 8 * (i >> 2) + cq + (i & 1); };
      // P^T from S^T and the queries' lse (log2 units), masked only on a
      // tile that crosses an edge
      auto probs = [&](float (&x)[32]) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float y = x[i] * scale_log2;
          if (edge) {
            const int ka = k0 + r_lo + 8 * ((i >> 1) & 1);
            if (!pair_valid(q0 + col(i) + q_offset, ka, sk, causal, window)) y = -INFINITY;
          }
          x[i] = exp2f(y - st[col(i)]);
        }
      };
      // S^T = K Q^T or dP^T = V dO^T: keys are M, queries N, both K-major
      auto scores = [&](float (&x)[32], uint32_t sA, uint32_t sB) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kq = 0; kq < 4; ++kq) {
            const uint32_t off = c * kBoxBytes + kq * 32;
            hopper::wgmma_m64n64k16_ss(x, hopper::sw128_desc(sA + off, 16, 1024),
                                       hopper::sw128_desc(sB + off, 16, 1024),
                                       (c | kq) != 0);
          }
      };
      // a (keys x queries) tile as bf16 A fragments, 16 queries a step
      auto frags = [&](uint32_t (&fa)[4][4], const float (&x)[32]) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            fa[kk][r] = hopper::pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
      };
      // acc += fa B, B MN-major (d contiguous): a 16-query step is two
      // 8-row groups of a box, 1024 bytes apart, the next step 2048 on
      auto accumulate = [&](float (&a)[NC][32], const uint32_t (&fa)[4][4], uint32_t sB) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            hopper::wgmma_m64n64k16_rs_tb(
                a[c], fa[kk], hopper::sw128_desc(sB + c * kBoxBytes + kk * 2048, 1024, 1024));
      };

      hopper::mbar_wait(bar_qdo(stage), parity);
      if constexpr (NWG == 2) {
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        hopper::fence_regs(s);
        hopper::wgmma_fence();
        scores(s, wg == 0 ? sK : sV, wg == 0 ? sQ(stage) : sdO(stage));
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
        hopper::fence_regs(s);
        if (wg == 0) {
          probs(s);
#pragma unroll
          for (int i = 0; i < 32; ++i) xbuf[i * kWgThreads + wtid] = s[i];
          hopper::bar_arrive(kBarP, 2 * kWgThreads);
        } else {
          // dS^T = P^T (dP^T - D), P^T from warpgroup 0's thread of the
          // same index, which holds the same (key, query) elements
          hopper::bar_sync(kBarP, 2 * kWgThreads);
#pragma unroll
          for (int i = 0; i < 32; ++i)
            s[i] = xbuf[i * kWgThreads + wtid] * (s[i] - st[kTile + col(i)]);
        }
        uint32_t fa[4][4];
        frags(fa, s);
#pragma unroll
        for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);
        hopper::wgmma_fence();
        accumulate(acc, fa, wg == 0 ? sdO(stage) : sQ(stage));  // dV or dK
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(fa[kk]);
      } else {
        // S^T and dP^T as two commit groups; P^T while dP^T finishes, then
        // dV += P^T dO while dS^T is formed, then dK += dS^T Q
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = 0.f;
          dp[i] = 0.f;
        }
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        hopper::wgmma_fence();
        scores(s, sK, sQ(stage));
        hopper::wgmma_commit();
        scores(dp, sV, sdO(stage));
        hopper::wgmma_commit();
        hopper::wgmma_wait_1();
        hopper::fence_regs(s);
        probs(s);
        uint32_t fp[4][4], fd[4][4];
        frags(fp, s);
#pragma unroll
        for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);
        hopper::wgmma_fence();
        accumulate(acc, fp, sdO(stage));  // dV += P^T dO
        hopper::wgmma_commit();
        hopper::wgmma_wait_1();  // dP^T is done; dV may still run
        hopper::fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - st[kTile + col(i)]);
        frags(fd, dp);
#pragma unroll
        for (int c = 0; c < NC; ++c) hopper::fence_regs(acc2[c]);
        hopper::wgmma_fence();
        accumulate(acc2, fd, sQ(stage));  // dK += dS^T Q
        hopper::wgmma_commit();
        hopper::wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          hopper::fence_regs(acc[c]);
          hopper::fence_regs(acc2[c]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::fence_regs(fp[kk]);
          hopper::fence_regs(fd[kk]);
        }
      }

      __syncthreads();  // every warp is done with this stage (and the exchange)
      if (tid == 0 && j + kStages < n_steps) load_qdo(stage, j + kStages);
    }

    // store: dK carries the scale; with splits, fp32 partials (2, splits,
    // b, sk, hkv, D), dK first, then dV
    const int64_t rs = static_cast<int64_t>(hkv) * D;
    const int64_t off = static_cast<int64_t>(b) * sk * rs + static_cast<int64_t>(hk) * D;
    const int64_t n = static_cast<int64_t>(nb) * sk * rs;
    const bool is_dk = NWG == 2 && wg == 1;
    if (splits == 1) {
      store_rows(acc, (is_dk ? dk : dv) + off, rs, k0, r_lo, cq, sk, is_dk ? scale : 1.f);
      if constexpr (NWG == 1) store_rows(acc2, dk + off, rs, k0, r_lo, cq, sk, scale);
    } else {
      float* pk = part + g * n + off;  // this split's dK partial
      float* pv = pk + splits * n;
      store_rows(acc, is_dk ? pk : pv, rs, k0, r_lo, cq, sk, is_dk ? scale : 1.f);
      if constexpr (NWG == 1) store_rows(acc2, pk, rs, k0, r_lo, cq, sk, scale);
    }
  }
}

// (c) dK and dV from the splits' fp32 partials, summed in split order, in
// T; n4 = b sk hkv d / 4 (d is a multiple of 64).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
                     int64_t n4, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 2 * n4) return;
  const int which = idx >= n4;  // 0: dK, 1: dV
  const int64_t i = idx - which * n4;
  const float4* src = reinterpret_cast<const float4*>(part) + which * splits * n4 + i;
  float4 a = src[0];
  for (int g = 1; g < splits; ++g) {
    const float4 x = src[g * n4];
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(which ? dv : dk)[i] = a;
  } else {
    uint2 out;
    out.x = hopper::pack_bf16(a.x, a.y);
    out.y = hopper::pack_bf16(a.z, a.w);
    reinterpret_cast<uint2*>(which ? dv : dk)[i] = out;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO and kStages x (K, V), D / 64 boxes each, then the barriers
  return 1024 + static_cast<size_t>(2 + 2 * kStages) * (D / 64) * kBoxBytes +
         8 * (1 + kStages);
}

// (d) dQ of one query tile of one query head, over the key tiles of the
// band.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ stats,
                          __nv_bfloat16* __restrict__ dq, int sq, int sk, int hq, int hkv,
                          float scale, float scale_log2, int causal, int window,
                          int q_offset) {
  constexpr int NC = D / 64;
  constexpr uint32_t kTileBytes = NC * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + kTileBytes;
  auto sK = [&](int s) { return sQ + (2u + 2u * s) * kTileBytes; };
  auto sV = [&](int s) { return sK(s) + kTileBytes; };
  const uint32_t bar_qdo = sQ + (2 + 2 * kStages) * kTileBytes;
  auto bar_kv = [&](int s) { return bar_qdo + 8u * (1 + s); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // longest tiles first
  const int hk = h / (hq / hkv);
  const Band kb = key_band(q0, sq, sk, causal, window, q_offset);
  const int n_tiles = kb.size();

  if (tid == 0) {
    hopper::mbar_init(bar_qdo, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(bar_kv(s), 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kTile;
    hopper::mbar_arrive_expect_tx(bar_kv(stage), 2 * kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      hopper::tma_load_4d(sK(stage) + c * kBoxBytes, &tm_k, bar_kv(stage), c * 64, hk, k0,
                          b);
      hopper::tma_load_4d(sV(stage) + c * kBoxBytes, &tm_v, bar_kv(stage), c * 64, hk, k0,
                          b);
    }
  };
  if (tid == 0 && n_tiles > 0) {
    hopper::mbar_arrive_expect_tx(bar_qdo, 2 * kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      hopper::tma_load_4d(sQ + c * kBoxBytes, &tm_q, bar_qdo, c * 64, h, q0, b);
      hopper::tma_load_4d(sdO + c * kBoxBytes, &tm_do, bar_qdo, c * 64, h, q0, b);
    }
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, kb.lo + s);
  }

  // rows (queries) r_lo and r_lo + 8; columns (keys, or d) cq, cq + 1 of
  // each 8-column group
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float* st = stats + ((static_cast<int64_t>(b) * hq + h) * gridDim.z +
                              q0 / kTile) * kStatFloats;
  float m[2], dd[2];  // lse in log2 units and D of the two rows
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m[hr] = __ldg(st + r_lo + 8 * hr);
    dd[hr] = __ldg(st + kTile + r_lo + 8 * hr);
  }
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

  if (n_tiles > 0) hopper::mbar_wait(bar_qdo, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = (kb.lo + j) * kTile;

    // S = Q K^T and dP = dO V^T, K-major, one commit group each
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    hopper::mbar_wait(bar_kv(stage), parity);
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const uint32_t off = c * kBoxBytes + kq * 32;
        hopper::wgmma_m64n64k16_ss(s, hopper::sw128_desc(sQ + off, 16, 1024),
                                   hopper::sw128_desc(sK(stage) + off, 16, 1024),
                                   (c | kq) != 0);
      }
    hopper::wgmma_commit();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const uint32_t off = c * kBoxBytes + kq * 32;
        hopper::wgmma_m64n64k16_ss(dp, hopper::sw128_desc(sdO + off, 16, 1024),
                                   hopper::sw128_desc(sV(stage) + off, 16, 1024),
                                   (c | kq) != 0);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait_1();  // S is done; dP may still run
    hopper::fence_regs(s);

    // P, masked only on a tile that crosses an edge
    const bool edge = crosses_edge(q0, kTile, k0, kTile, sq, sk, causal, window, q_offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int qa = q0 + r_lo + 8 * ((i >> 1) & 1) + q_offset;
        const int ka = k0 + 8 * (i >> 2) + cq + (i & 1);
        if (!pair_valid(qa, ka, sk, causal, window)) x = -INFINITY;
      }
      s[i] = exp2f(x - m[(i >> 1) & 1]);
    }
    hopper::wgmma_wait_all();
    hopper::fence_regs(dp);

    // dS = P (dP - D) as bf16 A fragments, 16 keys a step
    uint32_t fa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float d0 = dd[(i >> 1) & 1];
        fa[kk][r] = hopper::pack_bf16(s[i] * (dp[i] - d0), s[i + 1] * (dp[i + 1] - d0));
      }

    // dQ += dS K: K is MN-major (d contiguous)
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n64k16_rs_tb(
            acc[c], fa[kk],
            hopper::sw128_desc(sK(stage) + c * kBoxBytes + kk * 2048, 1024, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(fa[kk]);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && j + kStages < n_tiles) load_kv(stage, kb.lo + j + kStages);
  }

  // store, scaled: rows past sq are not written
  const int64_t row_stride = static_cast<int64_t>(hq) * D;
  __nv_bfloat16* qb = dq + static_cast<int64_t>(b) * sq * row_stride +
                      static_cast<int64_t>(h) * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qr = q0 + r_lo + 8 * hr;
    if (qr >= sq) continue;
    __nv_bfloat16* drow = qb + qr * row_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int i = 4 * i8 + 2 * hr;
        *reinterpret_cast<uint32_t*>(drow + c * 64 + 8 * i8 + cq) =
            hopper::pack_bf16(acc[c][i] * scale, acc[c][i + 1] * scale);
      }
  }
}

// ---------------------------------------------------------------------------
// fp32 tensor-core route: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 256;  // two warpgroups of four warps
constexpr int kBarX = 2;         // named barrier: P (P^T) handed from half 0 to half 1
constexpr int kBarDs = 3;        // named barrier: dS handed back (dQ pass)
constexpr int kBarS = 3;         // named barriers 3, 4: a warpgroup's halves of the scores (dK/dV)

// Rows of a streamed tile (queries in the dK/dV pass, keys in the dQ
// pass): 64 at d = 64, 32 at d = 128 and 16 at d = 256, which keeps a
// step's score tiles and fragments in registers beside the accumulator
// (and, at d = 256, the resident 64-row fp32 tiles already take 130 KB).
template <int D>
constexpr int kTcStream = D == 256 ? 16 : D == 128 ? 32 : 64;
// padded fp32 row: D + 4 = 4 (mod 32) words, so the scalar fragment reads
// (rows g, columns q) and the float2 reads (rows 2q, 2q + 1; columns 2g)
// hit 32 distinct banks
template <int D>
constexpr int kTcLd = D + 4;
// Halves of the dK/dV pass: at d = 256 a thread's d-wide accumulator for
// its keys (128 registers) beside the products' fragments spills, so there
// the two warps that share 16 keys split d: each computes its half of S^T
// (dP^T), the halves are exchanged and summed in a fixed order, and each
// accumulates its half of dV's (dK's) columns; a walk of the band then
// covers 32 of the tile's 64 keys, and the band is walked twice.
template <int D>
constexpr int kTcHalves = D == 256 ? 2 : 1;

template <int D>
constexpr size_t tc_smem_bytes() {
  // two resident 64-row tiles; kStages x two streamed tiles and their
  // query statistics (lse, D); the P^T exchange (64 x stream floats); with
  // halves, each warp's part of the scores (8 warps x 16 x stream floats)
  return sizeof(float) * (2 * kTile * kTcLd<D> + kStages * 2 * kTcStream<D> * kTcLd<D> +
                          kStages * 2 * kTcStream<D> + kTile * kTcStream<D> +
                          (kTcHalves<D> == 2 ? 8 * 16 * kTcStream<D> : 0));
}

// Rows r0 .. r0 + R - 1 of one head of a contiguous (b, s, h, D) fp32
// tensor into shared memory (row stride kTcLd) by cp.async, 16 bytes a
// copy, spread over the block; rows at or past n are zero-filled.
template <int D, int R>
__device__ __forceinline__ void stage_rows_tc(float* dst, const float* __restrict__ base,
                                              int r0, int n, int64_t row_stride) {
  constexpr int kChunks = D / 4;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const bool live = r0 + r < n;
    const float* src = live ? base + static_cast<int64_t>(r0 + r) * row_stride + c : base;
    hopper::cp_async16(hopper::smem_addr(dst + r * kTcLd<D> + c), src, live);
  }
}

// acc (16 rows x 16 columns a pair of n tiles) += A B over 8 NT of the
// product's inner rows, with A (16 x 8 NT) from accumulator tiles x of this
// warp: x[n][0..3] hold A's rows g, g + 8 and inner columns 8 n + 2 q and
// + 1, taken as the fragment's inner indices q and q + 4 (any permutation
// of the inner index that A and B share gives the same sum). B's inner
// rows 8 n + 2 q and + 1 are read from `rows` (stride kTcLd), columns c0 +
// 16 p + 2 g and + 1 as float2 (one for each n tile of the pair).
// acc[p][e][i] then holds row g + 8 (i / 2), column c0 + 16 p + 4 q +
// 2 (i % 2) + e. A column pair's products over up to four n tiles (32
// inner rows) are summed in a fresh accumulator, then added to acc by an
// fp32 add: the tensor cores' accumulation does not round to nearest, and
// over a band of thousands of rows its error grows past 1e-5 (measured at
// (1, 4096)); here it spans 32 rows.
template <int D, int NT, int NP>
__device__ __forceinline__ void accumulate_tc(float (&acc)[NP][2][4], const float (&x)[NT][4],
                                              const float* rows, int c0, int g, int q) {
  constexpr int kChunk = NT < 4 ? NT : 4;
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += kChunk) {
    hopper::Tf32Split<4> a[kChunk];
#pragma unroll
    for (int n = 0; n < kChunk; ++n) {
      a[n].set(0, x[n0 + n][0]);
      a[n].set(1, x[n0 + n][2]);
      a[n].set(2, x[n0 + n][1]);
      a[n].set(3, x[n0 + n][3]);
    }
    const float* r_lo = rows + (8 * n0 + 2 * q) * kTcLd<D> + c0 + 2 * g;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float part[2][4] = {};
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        const float* r = r_lo + 8 * n * kTcLd<D> + 16 * p;
        const float2 lo = *reinterpret_cast<const float2*>(r);
        const float2 hi = *reinterpret_cast<const float2*>(r + kTcLd<D>);
        hopper::Tf32Split<2> b0, b1;
        b0.set(0, lo.x);
        b0.set(1, hi.x);
        b1.set(0, lo.y);
        b1.set(1, hi.y);
        hopper::mma_m16n8k8_3xtf32(part[0], a[n], b0);
        hopper::mma_m16n8k8_3xtf32(part[1], a[n], b1);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[p][e][i] += part[e][i];
    }
  }
}

// x (16 rows x 8 NT columns) = A B^T over DC columns, A's rows a_rows ..
// + 15 and B's rows 0 .. 8 NT - 1 (both stride kTcLd<D>, the pointers at
// the first column). x[n][i] holds row g + 8 (i / 2), column 8 n + 2 q +
// i % 2. Summed 32 columns at a time in a fresh accumulator, then by fp32
// adds (see accumulate_tc).
template <int D, int NT, int DC = D>
__device__ __forceinline__ void scores_tc(float (&x)[NT][4], const float* a_rows,
                                          const float* b_rows, int g, int q) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[n][i] = 0.f;
  const float* a0 = a_rows + g * kTcLd<D> + q;
  const float* a1 = a0 + 8 * kTcLd<D>;
  const float* b0 = b_rows + g * kTcLd<D> + q;
#pragma unroll 1
  for (int c0 = 0; c0 < DC; c0 += 32) {
    float part[NT][4] = {};
#pragma unroll
    for (int c = c0; c < c0 + 32; c += 8) {
      hopper::Tf32Split<4> a;
      a.set(0, a0[c]);
      a.set(1, a1[c]);
      a.set(2, a0[c + 4]);
      a.set(3, a1[c + 4]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        hopper::Tf32Split<2> b;
        b.set(0, b0[n * 8 * kTcLd<D> + c]);
        b.set(1, b0[n * 8 * kTcLd<D> + c + 4]);
        hopper::mma_m16n8k8_3xtf32(part[n], a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[n][i] += part[n][i];
  }
}

// An accumulator of accumulate_tc (rows r0 + g and + 8 of a (rows, row
// stride rs) fp32 matrix, columns c0 + ...) times mult, as float4 stores;
// rows at or past n are not written.
template <int NP>
__device__ __forceinline__ void store_tc(const float (&acc)[NP][2][4], float* dst, int64_t rs,
                                         int r0, int n, int c0, int q, float mult) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (r0 + 8 * hr >= n) continue;
    float* row = dst + static_cast<int64_t>(r0 + 8 * hr) * rs + c0 + 4 * q;
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<float4*>(row + 16 * p) =
          make_float4(acc[p][0][2 * hr] * mult, acc[p][1][2 * hr] * mult,
                      acc[p][0][2 * hr + 1] * mult, acc[p][1][2 * hr + 1] * mult);
  }
}

// (b) dK and dV of one or two 64-key tiles of one kv head, summed over a
// split of the group's query heads and the query tiles of the band, in
// 3xTF32. Warp w of warpgroup 0 and warp w of warpgroup 1 share keys
// 16 w .. 16 w + 15: the first computes S^T = K Q^T, P^T and dV += P^T dO;
// the second dP^T = V dO^T, dS^T = P^T (dP^T - D) and dK += dS^T Q, with
// P^T handed over through shared memory in the accumulator's thread order.
// With halves (d = 256) warps w and w + 2 of a warpgroup share keys
// 16 (w % 2) of a 32-key half, each on its half of d; the band is walked
// once for each 32-key half, the ring streaming on from one walk into the
// next.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ stats, float* __restrict__ dk,
                           float* __restrict__ dv, float* __restrict__ part, int nb, int sq,
                           int sk, int hq, int hkv, int n_kt, int splits, int paired,
                           float scale, int causal, int window, int q_offset) {
  constexpr int H = kTcHalves<D>;
  constexpr int DC = D / H;             // columns of d a warp computes on
  constexpr int BS = kTcStream<D>;      // queries a step
  constexpr int LD = kTcLd<D>;
  constexpr int NT = BS / 8;            // 8-query n tiles of S^T
  constexpr int NP = DC / 16;           // pairs of 8-column n tiles of dV or dK
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* ring = sV + kTile * LD;  // kStages x (Q, dO)
  float* sSt = ring + kStages * 2 * BS * LD;  // kStages x (lse, D), BS each
  float* xbuf = sSt + kStages * 2 * BS;        // P^T, 64 x BS
  float* xpart = xbuf + kTile * BS;            // H = 2: each warp's part of the scores

  const int tid = threadIdx.x;
  const int half = tid / kWgThreads;  // 0: S^T, P^T, dV; 1: dP^T, dS^T, dK
  const int wtid = tid % kWgThreads;
  const int wr = wtid >> 5;
  const int kg = H == 2 ? wr & 1 : wr;             // 16-key group within a walk's keys
  const int c_lo = H == 2 ? (wr >> 1) * DC : 0;  // this warp's columns of d
  const int lane = tid & 31;
  const int xslot = kg * 32 + lane;  // P^T's slot: the writer's (c_lo = 0) thread
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int p = blockIdx.x;
  const int split = blockIdx.y;
  const int b = blockIdx.z / hkv;
  const int hk = blockIdx.z % hkv;
  const int n_rep = hq / hkv;
  const int heads = n_rep / splits;
  const int h0 = hk * n_rep + split * heads;
  const int n_mine = paired && n_kt - 1 - p != p ? 2 : 1;
  const int n_qt = (sq + kTile - 1) / kTile;
  const int64_t q_row = static_cast<int64_t>(hq) * D;
  const int64_t kv_row = static_cast<int64_t>(hkv) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * sk * kv_row + static_cast<int64_t>(hk) * D;
  // dK carries the scale; with splits, fp32 partials (2, splits, b, sk,
  // hkv, D), dK first, then dV
  const int64_t n_part = static_cast<int64_t>(nb) * sk * kv_row;
  float* dst = (splits == 1 ? (half == 1 ? dk : dv)
                            : part + (half == 1 ? split : splits + split) * n_part) +
               kv_off;

  for (int t = 0; t < n_mine; ++t) {
    const int k0 = (t == 0 ? p : n_kt - 1 - p) * kTile;
    // query rows that see a key of this tile: [q_lo, q_hi), in BS-row steps
    const int k_last = min(k0 + kTile, sk) - 1;
    const int q_lo = causal ? max(0, k0 - q_offset) : 0;
    const int q_hi = window > 0 ? min(sq, k_last + window - q_offset) : sq;
    const int j_lo = q_lo / BS;
    const int n_q = q_hi > q_lo ? (q_hi + BS - 1) / BS - j_lo : 0;
    const int n_steps = heads * n_q;  // a walk's
    auto load_step = [&](int s) {  // step s % n_steps of walk s / n_steps
      const int j = H == 2 ? s % n_steps : s;
      const int h = h0 + j / n_q;
      const int q0 = (j_lo + j % n_q) * BS;
      const int64_t q_off = static_cast<int64_t>(b) * sq * q_row + static_cast<int64_t>(h) * D;
      float* sQ = ring + (s % kStages) * 2 * BS * LD;
      stage_rows_tc<D, BS>(sQ, q + q_off, q0, sq, q_row);
      stage_rows_tc<D, BS>(sQ + BS * LD, dout + q_off, q0, sq, q_row);
      // the rows' lse, then D: BS of each from the tile's 512-byte record
      const float* rec = stats + ((static_cast<int64_t>(b) * hq + h) * n_qt + q0 / kTile) *
                                     kStatFloats + q0 % kTile;
      float* st = sSt + (s % kStages) * 2 * BS;
      if (tid < BS / 2) {
        const int which = tid / (BS / 4);  // 0: lse, 1: D
        const int c = (tid % (BS / 4)) * 4;
        hopper::cp_async16(hopper::smem_addr(st + which * BS + c), rec + which * kTile + c,
                           true);
      }
    };

    float acc[NP][2][4];  // dV (half 0) or dK (half 1): a walk's keys g (+ 8) of this warp
    auto zero = [&] {
#pragma unroll
      for (int c = 0; c < NP; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[c][e][i] = 0.f;
    };
    zero();
    const float mult = half == 1 ? scale : 1.f;
    if (n_steps == 0) {  // no query sees the tile: zero gradients
      for (int w = 0; w < H; ++w)
        store_tc<NP>(acc, dst, kv_row, k0 + w * 32 + kg * 16 + g, sk, c_lo, qd, mult);
      continue;
    }

    __syncthreads();  // every thread is done with the previous key tile
    stage_rows_tc<D, kTile>(sK, k + kv_off, k0, sk, kv_row);
    stage_rows_tc<D, kTile>(sV, v + kv_off, k0, sk, kv_row);
    load_step(0);
    hopper::cp_async_commit();
    const int n_total = H * n_steps;
    for (int s = 0; s < n_total; ++s) {
      if (s + 1 < n_total) load_step(s + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait(1);  // step s (and K, V) landed
      __syncthreads();
      const int j = H == 2 ? s % n_steps : s;
      const int kr = (H == 2 ? s / n_steps * 32 : 0) + kg * 16;  // this warp's keys in the tile
      const int q0 = (j_lo + j % n_q) * BS;
      const float* sQ = ring + (s % kStages) * 2 * BS * LD;
      const float* sdO = sQ + BS * LD;
      const float* st = sSt + (s % kStages) * 2 * BS;  // lse, then D
      float x[NT][4];
      scores_tc<D, NT, DC>(x, (half == 0 ? sK : sV) + kr * LD + c_lo,
                           (half == 0 ? sQ : sdO) + c_lo, g, qd);
      if constexpr (H == 2) {
        // the partner's half of the same scores, summed in column order
        float* mine = xpart + (half * 4 + wr) * 16 * BS;
        const float* other = xpart + (half * 4 + (wr ^ 2)) * 16 * BS;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) mine[(4 * n + i) * 32 + lane] = x[n][i];
        hopper::bar_sync(kBarS + half, kWgThreads);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float y = other[(4 * n + i) * 32 + lane];
            x[n][i] = c_lo == 0 ? x[n][i] + y : y + x[n][i];
          }
      }
      if (half == 0) {
        // P^T, masked only on a tile that crosses an edge
        const bool edge = crosses_edge(q0, BS, k0, kTile, sq, sk, causal, window, q_offset);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 8 * n + 2 * qd + (i & 1);
            const int ka = k0 + kr + g + 8 * (i >> 1);
            const bool ok = !edge || pair_valid(q0 + col + q_offset, ka, sk, causal, window);
            x[n][i] = ok ? expf(x[n][i] * scale - st[col]) : 0.f;
            if (c_lo == 0) xbuf[(4 * n + i) * kWgThreads + xslot] = x[n][i];
          }
        if (c_lo == 0) hopper::bar_arrive(kBarX, kWgThreads + kWgThreads / H);
        accumulate_tc<D, NT, NP>(acc, x, sdO, c_lo, g, qd);
      } else {
        // dS^T = P^T (dP^T - D), P^T from warpgroup 0's thread of the same
        // index, which holds the same (key, query) elements
        hopper::bar_sync(kBarX, kWgThreads + kWgThreads / H);
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[n][i] = xbuf[(4 * n + i) * kWgThreads + xslot] *
                      (x[n][i] - st[BS + 8 * n + 2 * qd + (i & 1)]);
        accumulate_tc<D, NT, NP>(acc, x, sQ, c_lo, g, qd);
      }
      __syncthreads();  // every warp is done with this stage and the exchanges
      if (j == n_steps - 1) {  // the walk is done: its keys
        store_tc<NP>(acc, dst, kv_row, k0 + kr + g, sk, c_lo, qd, mult);
        zero();
      }
    }
    hopper::cp_async_wait(0);
  }
}

// (d) dQ of one 64-query tile of one query head, over the key tiles of the
// band, in 3xTF32. Warp w of warpgroup 0 and warp w of warpgroup 1 share
// queries 16 w .. 16 w + 15: the first computes S = Q K^T and P, the
// second dP = dO V^T and dS = P (dP - D), handed back through shared
// memory; each then accumulates half of dQ's columns, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ stats, float* __restrict__ dq, int sq,
                         int sk, int hq, int hkv, float scale, int causal, int window,
                         int q_offset) {
  constexpr int BS = kTcStream<D>;  // keys a step
  constexpr int LD = kTcLd<D>;
  constexpr int NT = BS / 8;        // 8-key n tiles of S
  constexpr int NP = D / 32;        // pairs of 8-column n tiles of half of dQ
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * LD;
  float* ring = sdO + kTile * LD;  // kStages x (K, V)
  float* xbuf = ring + kStages * 2 * BS * LD + kStages * 2 * BS;  // P, then dS

  const int tid = threadIdx.x;
  const int half = tid / kWgThreads;  // 0: S, P; 1: dP, dS; each half of dQ
  const int wtid = tid % kWgThreads;
  const int qr = (wtid >> 5) * 16;  // this warp's queries within the tile
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // longest tiles first
  const int hk = h / (hq / hkv);
  const int64_t q_row = static_cast<int64_t>(hq) * D;
  const int64_t kv_row = static_cast<int64_t>(hkv) * D;
  const int64_t q_off = static_cast<int64_t>(b) * sq * q_row + static_cast<int64_t>(h) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * sk * kv_row + static_cast<int64_t>(hk) * D;

  // keys this query tile sees: [k_lo, k_hi), in BS-key steps
  const int qa_first = q0 + q_offset;
  const int qa_last = min(q0 + kTile, sq) - 1 + q_offset;
  const int k_lo = window > 0 ? max(0, qa_first - window + 1) : 0;
  const int k_hi = causal ? min(sk, qa_last + 1) : sk;
  const int j_lo = k_lo / BS;
  const int n_tiles = k_hi > k_lo ? (k_hi + BS - 1) / BS - j_lo : 0;

  auto load_kv = [&](int j) {
    float* sK = ring + (j % kStages) * 2 * BS * LD;
    stage_rows_tc<D, BS>(sK, k + kv_off, (j_lo + j) * BS, sk, kv_row);
    stage_rows_tc<D, BS>(sK + BS * LD, v + kv_off, (j_lo + j) * BS, sk, kv_row);
  };
  if (n_tiles > 0) {
    stage_rows_tc<D, kTile>(sQ, q + q_off, q0, sq, q_row);
    stage_rows_tc<D, kTile>(sdO, dout + q_off, q0, sq, q_row);
    load_kv(0);
  }
  hopper::cp_async_commit();

  // lse (natural units, +inf for no valid key or past sq) and D of rows
  // qr + g and qr + g + 8
  const float* rec = stats + ((static_cast<int64_t>(b) * hq + h) * gridDim.z + q0 / kTile) *
                                 kStatFloats;
  float m[2], dd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m[hr] = __ldg(rec + qr + g + 8 * hr);
    dd[hr] = __ldg(rec + kTile + qr + g + 8 * hr);
  }
  float acc[NP][2][4];
#pragma unroll
  for (int c = 0; c < NP; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][e][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv(j + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait(1);  // tile j (and Q, dO) landed
    __syncthreads();
    const int k0 = (j_lo + j) * BS;
    const float* sK = ring + (j % kStages) * 2 * BS * LD;
    const float* sV = sK + BS * LD;
    float x[NT][4];
    scores_tc<D, NT>(x, (half == 0 ? sQ : sdO) + qr * LD, half == 0 ? sK : sV, g, qd);
    if (half == 0) {
      // P, masked only on a tile that crosses an edge
      const bool edge = crosses_edge(q0, kTile, k0, BS, sq, sk, causal, window, q_offset);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qa = q0 + qr + g + 8 * (i >> 1) + q_offset;
          const int ka = k0 + 8 * n + 2 * qd + (i & 1);
          const bool ok = !edge || pair_valid(qa, ka, sk, causal, window);
          xbuf[(4 * n + i) * kWgThreads + wtid] =
              ok ? expf(x[n][i] * scale - m[i >> 1]) : 0.f;
        }
      hopper::bar_arrive(kBarX, kTcThreads);
      hopper::bar_sync(kBarDs, kTcThreads);  // dS is back
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) x[n][i] = xbuf[(4 * n + i) * kWgThreads + wtid];
    } else {
      hopper::bar_sync(kBarX, kTcThreads);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* slot = xbuf + (4 * n + i) * kWgThreads + wtid;
          x[n][i] = *slot * (x[n][i] - dd[i >> 1]);
          *slot = x[n][i];
        }
      hopper::bar_arrive(kBarDs, kTcThreads);
    }
    accumulate_tc<D, NT, NP>(acc, x, sK, half * (D / 2), g, qd);
    __syncthreads();  // every warp is done with this stage and the exchange
  }
  hopper::cp_async_wait(0);
  store_tc<NP>(acc, dq + q_off, q_row, q0 + qr + g, sq, half * (D / 2), qd, scale);
}

// cudaFuncSetAttribute for a kernel's dynamic shared memory, once per
// device (a bit of `done` each).
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, size_t bytes, int device,
                          std::atomic<uint64_t>& done) {
  const uint64_t bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// (a) D = rowsum(dO O) for every (batch, query, head) row.
template <typename T>
cudaError_t launch_dot(const void* o, const void* dout, float* dvec, int b, int sq, int hq,
                       int d, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(b) * sq * hq;
  const unsigned int blocks =
      static_cast<unsigned int>((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_dot_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dvec, rows, sq, hq, d);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* dvec, void* dq, void* dk,
                   void* dv, int b, int sq, int sk, int hq, int hkv, float scale,
                   int causal, int window, int q_offset, int device, cudaStream_t stream) {
  using Tl = Tile<D>;
  static std::atomic<uint64_t> smem_kv{0};
  static std::atomic<uint64_t> smem_q{0};
  cudaError_t err = set_smem_once(flash_bwd_dkdv_kernel<T, D>, Tl::smem_bytes, device, smem_kv);
  if (err == cudaSuccess)
    err = set_smem_once(flash_bwd_dq_kernel<T, D>, Tl::smem_bytes, device, smem_q);
  if (err != cudaSuccess) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);

  err = launch_dot<T>(o, dout, dvec, b, sq, hq, D, stream);
  if (err != cudaSuccess) return err;

  const dim3 kv_grid((sk + Tl::BK - 1) / Tl::BK, hkv, b);
  flash_bwd_dkdv_kernel<T, D><<<kv_grid, kThreads, Tl::smem_bytes, stream>>>(
      qp, kp, vp, gp, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, hq, hkv,
      scale, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 q_grid((sq + Tl::BQ - 1) / Tl::BQ, hq, b);
  flash_bwd_dq_kernel<T, D><<<q_grid, kThreads, Tl::smem_bytes, stream>>>(
      qp, kp, vp, gp, lse, dvec, static_cast<T*>(dq), sq, sk, hq, hkv, scale, causal,
      window, q_offset);
  return cudaGetLastError();
}

// The SIMT route: d 16 and 32, fp32 and bf16.
template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* dvec, void* dq, void* dk,
                     void* dv, int b, int sq, int sk, int hq, int hkv, float scale,
                     int causal, int window, int q_offset, int device,
                     cudaStream_t stream) {
#define REPRO_FLASH_BWD_CASE(DIM)                                                  \
  case DIM:                                                                        \
    return launch<T, DIM>(q, k, v, o, dout, lse, dvec, dq, dk, dv, b, sq, sk, hq, hkv, \
                          scale, causal, window, q_offset, device, stream);
  switch (d) {
    REPRO_FLASH_BWD_CASE(16)
    REPRO_FLASH_BWD_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BWD_CASE
}

// The tensor-core route (bf16, d 64/128/256). Returns a cudaError_t, or
// minus a CUresult if a tensor map fails to encode.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* dvec, void* dq, void* dk,
                 void* dv, float* part, int b, int sq, int sk, int hq, int hkv,
                 const unsigned long long* geom, int splits, int paired, float scale,
                 int causal, int window, int q_offset, int device, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_kv{0};
  static std::atomic<uint64_t> smem_q{0};
  constexpr size_t kv_smem = dkdv_smem_bytes<D>();
  constexpr size_t q_smem = dq_smem_bytes<D>();
  cudaError_t err = set_smem_once(flash_bwd_dkdv_kernel_wgmma<D>, kv_smem, device, smem_kv);
  if (err == cudaSuccess)
    err = set_smem_once(flash_bwd_dq_kernel_wgmma<D>, q_smem, device, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const CUresult r = hopper::encode_bf16_map(&maps[i], bases[i], geom + 11 * i);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  const int n_qt = (sq + kTile - 1) / kTile;
  const int64_t rows = static_cast<int64_t>(b) * hq * n_qt * kTile;
  const unsigned int stat_blocks =
      static_cast<unsigned int>((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_stats_kernel<__nv_bfloat16, true><<<stat_blocks, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse,
      dvec, rows, sq, n_qt, hq, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto* dk_p = static_cast<__nv_bfloat16*>(dk);
  auto* dv_p = static_cast<__nv_bfloat16*>(dv);
  const float scale_log2 = scale * kLog2e;
  const int n_kt = (sk + kTile - 1) / kTile;
  const dim3 kv_grid(paired ? (n_kt + 1) / 2 : n_kt, splits, b * hkv);
  constexpr int kv_threads = kDkdvWarpgroups<D> * kWgThreads;
  flash_bwd_dkdv_kernel_wgmma<D><<<kv_grid, kv_threads, kv_smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], dvec, dk_p, dv_p, part, b, sq, sk, hq, hkv,
      n_kt, splits, paired, scale, scale_log2, causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const int64_t n4 = static_cast<int64_t>(b) * sk * hkv * D / 4;
    const unsigned int blocks = static_cast<unsigned int>((2 * n4 + 255) / 256);
    flash_bwd_sum_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(part, dk_p, dv_p, n4, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 q_grid(hq, b, n_qt);
  flash_bwd_dq_kernel_wgmma<D><<<q_grid, kWgThreads, q_smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], dvec, static_cast<__nv_bfloat16*>(dq), sq,
      sk, hq, hkv, scale, scale_log2, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 tensor-core route (d 64/128/256): D and the lse into the
// statistics layout, the dK/dV pass, the split sum, the dQ pass.
template <int D>
cudaError_t launch_tf32(const float* q, const float* k, const float* v, const float* o,
                        const float* dout, const float* lse, float* stats, float* dq,
                        float* dk, float* dv, float* part, int b, int sq, int sk, int hq,
                        int hkv, int splits, int paired, float scale, int causal,
                        int window, int q_offset, int device, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_kv{0};
  static std::atomic<uint64_t> smem_q{0};
  constexpr size_t smem = tc_smem_bytes<D>();
  cudaError_t err = set_smem_once(flash_bwd_dkdv_kernel_tf32<D>, smem, device, smem_kv);
  if (err == cudaSuccess) err = set_smem_once(flash_bwd_dq_kernel_tf32<D>, smem, device, smem_q);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kTile - 1) / kTile;
  const int64_t rows = static_cast<int64_t>(b) * hq * n_qt * kTile;
  const unsigned int stat_blocks =
      static_cast<unsigned int>((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_stats_kernel<float, false><<<stat_blocks, kThreads, 0, stream>>>(
      o, dout, lse, stats, rows, sq, n_qt, hq, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_kt = (sk + kTile - 1) / kTile;
  const dim3 kv_grid(paired ? (n_kt + 1) / 2 : n_kt, splits, b * hkv);
  flash_bwd_dkdv_kernel_tf32<D><<<kv_grid, kTcThreads, smem, stream>>>(
      q, k, v, dout, stats, dk, dv, part, b, sq, sk, hq, hkv, n_kt, splits, paired, scale,
      causal, window, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const int64_t n4 = static_cast<int64_t>(b) * sk * hkv * D / 4;
    const unsigned int blocks = static_cast<unsigned int>((2 * n4 + 255) / 256);
    flash_bwd_sum_kernel<float><<<blocks, 256, 0, stream>>>(part, dk, dv, n4, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 q_grid(hq, b, n_qt);
  flash_bwd_dq_kernel_tf32<D><<<q_grid, kTcThreads, smem, stream>>>(
      q, k, v, dout, stats, dq, sq, sk, hq, hkv, scale, causal, window, q_offset);
  return cudaGetLastError();
}

}  // namespace

// All tensors contiguous: q, o, dout, dq (b, sq, hq, d); k, v, dk, dv
// (b, sk, hkv, d); lse (from flash_attention_fwd) fp32 (b, hq, sq); the
// fp32 scratch `dvec` is (b, hq, sq) on the SIMT route and (b, hq,
// ceil(sq / 64), 2, 64) on the tensor-core routes (their statistics).
// dtype: 0 = float32, 1 = bfloat16; window <= 0 means none. The route is
// chosen by dtype and d alone (ops.bwd_route): d in {64, 128, 256} takes
// the tensor-core kernels, `wgmma` in bf16 and 3xTF32 `mma.sync` in fp32.
// Both need the plan's `splits` (a divisor of hq / hkv) and `paired` (key
// tiles p and n - 1 - p a block), and with splits > 1 the fp32 scratch
// `part` (2 x splits x b x sk x hkv x d); bf16 also needs `tma` (4 x 11
// values: q's, k's, v's and dout's tensor-map dims, byte strides and box).
// d 16 and 32 take the SIMT kernels, which ignore those four. A call
// without what its route needs is refused. Returns a cudaError_t (0 =
// ok), or minus a CUresult if a tensor map fails to encode.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   float* dvec, void* dq, void* dk, void* dv, int b,
                                   int sq, int sk, int hq, int hkv, int d, float scale,
                                   int causal, int window, int q_offset, int dtype,
                                   const unsigned long long* tma, float* part, int splits,
                                   int paired, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || sq <= 0 || sk <= 0 || hq <= 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tensor_cores = d == 64 || d == 128 || d == 256;
  if (tensor_cores &&
      (splits < 1 || (hq / hkv) % splits != 0 || (splits > 1 && part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && tensor_cores) {
    const float* f[5] = {static_cast<const float*>(q), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<const float*>(o),
                         static_cast<const float*>(dout)};
    auto* dq_p = static_cast<float*>(dq);
    auto* dk_p = static_cast<float*>(dk);
    auto* dv_p = static_cast<float*>(dv);
#define REPRO_FLASH_BWD_TF32(DIM)                                                       \
  return static_cast<int>(launch_tf32<DIM>(f[0], f[1], f[2], f[3], f[4], lse, dvec, dq_p, \
                                           dk_p, dv_p, part, b, sq, sk, hq, hkv, splits, \
                                           paired, scale, causal, window, q_offset,      \
                                           device, s));
    switch (d) {
      case 64:
        REPRO_FLASH_BWD_TF32(64)
      case 128:
        REPRO_FLASH_BWD_TF32(128)
      default:
        REPRO_FLASH_BWD_TF32(256)
    }
#undef REPRO_FLASH_BWD_TF32
  }
  if (dtype == 1 && tensor_cores) {
    if (tma == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_BWD_WGMMA(DIM)                                                    \
  return launch_wgmma<DIM>(q, k, v, o, dout, lse, dvec, dq, dk, dv, part, b, sq, sk, hq, \
                           hkv, tma, splits, paired, scale, causal, window, q_offset,    \
                           device, s);
    switch (d) {
      case 64:
        REPRO_FLASH_BWD_WGMMA(64)
      case 128:
        REPRO_FLASH_BWD_WGMMA(128)
      default:
        REPRO_FLASH_BWD_WGMMA(256)
    }
#undef REPRO_FLASH_BWD_WGMMA
  }
  if (dtype == 0)
    err = dispatch<float>(d, q, k, v, o, dout, lse, dvec, dq, dk, dv, b, sq, sk, hq, hkv,
                          scale, causal, window, q_offset, device, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(d, q, k, v, o, dout, lse, dvec, dq, dk, dv, b, sq, sk,
                                  hq, hkv, scale, causal, window, q_offset, device, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
