// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py: online-softmax attention
// with fp32 running max / sum / accumulator, GQA (query head h reads kv
// head h / n_rep, no KV duplication), causal and sliding-window masks with
// a query offset, key tiles outside the band skipped, fully-masked rows
// giving 0, output in the input dtype.
//
// Bound on the H100: operations. At the model's shapes (s = 2048,
// d = 128) attention does ~2 * 2 * s * s/2 * d operations per head against
// ~4 * s * d elements moved, far above the card's operations-per-byte line.
//
// Two routes, chosen by dtype and head size only (never because another
// failed):
//
// * bf16, d in {64, 128, 256}: `flash_fwd_kernel_wgmma`, on the tensor
//   cores. One warpgroup (128 threads) a block takes a 64-row query tile
//   (the wgmma M) of one head. Q and a ring of two K/V stages come in by
//   TMA, 128-byte swizzled, one mbarrier per K and per V tile of a stage,
//   issued by one thread of the same warpgroup (no producer warp), so the
//   next tile's copy overlaps this tile's products. S = Q K^T is
//   wgmma m64n64k16 with both operands K-major in shared memory; the
//   online softmax runs on the accumulator registers (exp2 with the scale
//   pre-multiplied by log2 e, row max and sum over the quad of lanes that
//   share a row); P is rounded to bf16 in registers, in the layout of a
//   wgmma A fragment, and O += P V is wgmma with A from registers and V
//   MN-major through the transpose bit, one n64 product per 64 columns of
//   d. Under the swizzle a box is at most 64 bf16 wide, so d = 128 and 256
//   load as 2 and 4 boxes. The tensor maps are rank 4 over the (b, s, h, d)
//   views, built on the host from the geometry the wrapper computes
//   (kernels/flash_attention/ops.py::tma_geometry); TMA's zero fill covers
//   a ragged last tile, and the keys past sk and the causal and window
//   edges are masked in the scores, on the tiles that cross an edge only.
//   The grid sends the longest causal query tiles first.
// * fp32 (any d), and bf16 with d in {16, 32}: `flash_fwd_kernel`, SIMT
//   fp32. Plain FMAs keep fp32 within 2e-5 of the fp32 reference (TF32 or
//   bf16 products would not); d = 16 and 32 are narrower than the swizzle.
//   One 256-thread block per (64-query tile, query head, batch) loops over
//   the live 64-key tiles of the band; K, then V, is staged as fp32 in
//   shared memory (rows padded by one word), each thread computes a 4x4
//   patch of the score tile and a 4 x (d/16) patch of the output. For
//   d = 256 that is ~146 KB of dynamic shared memory.
//
// Both routes can also write each row's log-sum-exp of the scaled scores
// (fp32 (b, hq, sq), natural units, -inf for a row with no valid key): the
// input of the backward kernels in flash_attention_bwd.cu.
//
// Layout: q (b, sq, hq, d), k/v (b, sk, hkv, d) as the model holds them,
// read through their batch/sequence/head strides with the last dimension
// contiguous, so no transpose or copy is needed. The output is written
// contiguous (b, sq, hq, d).
//
// Host cost a launch: the device is set only when it differs from the
// current one, the shared-memory attribute once per kernel and device,
// and the driver's tensor-map encoder is looked up once
// (hopper.cuh's encode_tiled; the library does not link libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// SIMT fp32 route
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid for the 64x64 tiles
constexpr float kNegInf = -1.0e38f;  // the TPU kernel's finite -inf

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

template <int D>
constexpr size_t smem_bytes() {
  // sQ (kBQ x D+1) + sKV (kBK x D+1) + sS (kBQ x kBK+1) + m, l, corr
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (D + 1) + static_cast<size_t>(kBK) * (D + 1) +
          static_cast<size_t>(kBQ) * (kBK + 1) + 3 * kBQ);
}

// Stage a kBK x D tile of k or v (rows k0.., masked past sk) as fp32.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int k0,
                                          int sk, int64_t row_stride) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int kr = k0 + r;
    dst[r * LD + c] = kr < sk ? to_f32(src[kr * row_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk,
                 int hq, int hkv, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                 int64_t v_ss, int64_t v_sh, float scale, int causal,
                 int window, int q_offset) {
  constexpr int LD = D + 1;
  constexpr int LS = kBK + 1;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKV = sQ + kBQ * LD;
  float* sS = sKV + kBK * LD;
  float* sM = sS + kBQ * LS;
  float* sL = sM + kBQ;
  float* sC = sL + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // score cols tx + 16*j; output cols tx + 16*c
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int qr = q0 + r;
    sQ[r * LD + c] = qr < sq ? to_f32(qb[qr * q_ss + c]) : 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }

  // Live keys of this query tile: [k_lo, k_hi) in absolute positions.
  const int qa_first = q0 + q_offset;
  const int qa_last = min(q0 + kBQ, sq) - 1 + q_offset;
  int k_lo = 0;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, qa_last + 1);
  if (window > 0) k_lo = max(k_lo, qa_first - window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's readers of sKV / sS are done
    load_tile<T, D>(sKV, kb, k0, sk, k_ss);
    __syncthreads();

    // scores: rows ty*4+i, cols tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sKV[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qa = q0 + r + q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int ka = k0 + col;
        bool ok = (q0 + r < sq) && (ka < sk);
        if (causal) ok = ok && (qa >= ka);
        if (window > 0) ok = ok && (ka > qa - window);
        sS[r * LS + col] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows w*8 .. w*8+7, a lane two columns
    {
      const int w = tid / 32;
      const int lane = tid % 32;
      for (int rr = 0; rr < 8; ++rr) {
        const int r = w * 8 + rr;
        const float a = sS[r * LS + lane];
        const float bb = sS[r * LS + lane + 32];
        float mx = fmaxf(a, bb);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = sM[r];
        const float m_new = fmaxf(m_prev, mx);
        const bool live = m_new > kNegInf / 2;  // row has a valid key so far
        const float pa = live ? expf(a - m_new) : 0.f;
        const float pb = live ? expf(bb - m_new) : 0.f;
        float sum = pa + pb;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        sS[r * LS + lane] = pa;
        sS[r * LS + lane + 32] = pb;
        __syncwarp();
        if (lane == 0) {
          const float corr = m_prev > kNegInf / 2 ? expf(m_prev - m_new) : 0.f;
          sL[r] = corr * sL[r] + sum;
          sM[r] = m_new;
          sC[r] = corr;
        }
      }
    }
    __syncthreads();
    load_tile<T, D>(sKV, vb, k0, sk, v_ss);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sC[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty * 4 + i) * LS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sKV[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();  // sL final before every thread reads it

  // log-sum-exp of the scaled scores, natural units, for the backward;
  // -inf for a row with no valid key
  if (lse != nullptr && tid < kBQ && q0 + tid < sq)
    lse[(static_cast<int64_t>(b) * hq + h) * sq + q0 + tid] =
        sM[tid] > kNegInf / 2 ? sM[tid] + logf(sL[tid]) : -INFINITY;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qr = q0 + r;
    if (qr >= sq) continue;
    const float inv_l = 1.f / fmaxf(sL[r], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * sq + qr) * hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] * inv_l);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core route
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;           // one warpgroup
constexpr int kTile = 64;                 // query rows a block, keys a tile
constexpr uint32_t kBoxBytes = 64 * 128;  // one TMA box: 64 rows of 64 bf16
constexpr int kStages = 2;                // K/V ring depth

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // Q and kStages x (K, V), D / 64 boxes each, then the barriers; 1 KB of
  // slack to put the tiles on the 1024-byte swizzle boundary
  return 1024 + static_cast<size_t>(1 + 2 * kStages) * (D / 64) * kBoxBytes +
         8 * (1 + 2 * kStages);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int sq, int sk, int hq, int hkv, float scale_log2,
                       int causal, int window, int q_offset) {
  constexpr int NC = D / 64;  // 64-wide column chunks of d (one box each)
  constexpr uint32_t kTileBytes = NC * kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  // stage s: K at sQ + (1 + 2 s) tiles, V right after it
  const uint32_t bars = sQ + (1 + 2 * kStages) * kTileBytes;
  const uint32_t bar_q = bars;
  auto bar_k = [&](int s) { return bars + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto sK = [&](int s) { return sQ + (1u + 2u * s) * kTileBytes; };
  auto sV = [&](int s) { return sK(s) + kTileBytes; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // longest tiles first
  const int hk = h / (hq / hkv);

  // Live keys of this query tile: [k_lo, k_hi) in absolute positions.
  const int qa_first = q0 + q_offset;
  const int qa_last = min(q0 + kTile, sq) - 1 + q_offset;
  int k_lo = 0;
  int k_hi = sk;
  if (causal) k_hi = min(k_hi, qa_last + 1);
  if (window > 0) k_lo = max(k_lo, qa_first - window + 1);
  const int t_lo = k_lo / kTile;
  const int t_hi = k_hi > 0 ? (k_hi + kTile - 1) / kTile : 0;
  const int n_tiles = max(0, t_hi - t_lo);

  if (tid == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar_k(s), 1);
      hopper::mbar_init(bar_v(s), 1);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int stage, int tile) {
    const int k0 = tile * kTile;
    hopper::mbar_arrive_expect_tx(bar_k(stage), kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      hopper::tma_load_4d(sK(stage) + c * kBoxBytes, map_k, bar_k(stage), c * 64, hk,
                          k0, b);
    hopper::mbar_arrive_expect_tx(bar_v(stage), kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      hopper::tma_load_4d(sV(stage) + c * kBoxBytes, map_v, bar_v(stage), c * 64, hk,
                          k0, b);
  };
  if (tid == 0 && n_tiles > 0) {
    hopper::mbar_arrive_expect_tx(bar_q, kTileBytes);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      hopper::tma_load_4d(sQ + c * kBoxBytes, &tm_q, bar_q, c * 64, h, q0, b);
    for (int s = 0; s < kStages && s < n_tiles; ++s) load_kv(s, t_lo + s);
  }

  // This thread's accumulator rows are r_lo and r_lo + 8 of the tile; in
  // each 8-column group it holds columns cq and cq + 1.
  const int r_lo = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's part of the sum

  if (n_tiles > 0) hopper::mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int k0 = (t_lo + j) * kTile;

    // S = Q K^T: K-major operands, 16 columns of d a step (32 bytes
    // inside a 128-byte swizzle row), the next box every 4 steps
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hopper::mbar_wait(bar_k(stage), parity);
    hopper::fence_regs(s);
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
    hopper::wgmma_wait_all();
    hopper::fence_regs(s);

    // scale to log2 units; mask only on tiles that cross an edge
    const bool edge = (k0 + kTile > sk) || (causal && k0 + kTile - 1 > qa_first) ||
                      (window > 0 && k0 <= qa_last - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int qa = q0 + r_lo + 8 * ((i >> 1) & 1) + q_offset;
        const int ka = k0 + 8 * (i >> 2) + cq + (i & 1);
        bool ok = ka < sk;
        if (causal) ok = ok && qa >= ka;
        if (window > 0) ok = ok && ka > qa - window;
        if (!ok) x = -INFINITY;
      }
      s[i] = x;
    }

    // online softmax, row by row (hr = 0: row r_lo, hr = 1: row r_lo + 8)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == hr) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hr], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet
      const float corr = exp2f(m_run[hr] - m_use);
      m_run[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == hr) {
          s[i] = exp2f(s[i] - m_use);
          sum += s[i];
        }
      l_run[hr] = l_run[hr] * corr + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == hr) acc[c][i] *= corr;
    }

    // P as bf16 A fragments, 16 keys a step: the accumulator of columns
    // 16 kk .. 16 kk + 15 is already in the A fragment's order
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O += P V: V is MN-major (d contiguous); a 16-key step is two 8-row
    // groups of a box, 1024 bytes apart, the next step 2048 bytes on; one
    // n64 product covers one box of columns, so the leading offset
    // (between boxes along n) is never used
    hopper::mbar_wait(bar_v(stage), parity);
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n64k16_rs_tb(
            acc[c], pa[kk],
            hopper::sw128_desc(sV(stage) + c * kBoxBytes + kk * 2048, 1024, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) hopper::fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(pa[kk]);

    __syncthreads();  // every warp is done with this stage
    if (tid == 0 && j + kStages < n_tiles) load_kv(stage, t_lo + j + kStages);
  }

  // normalise and store: rows past sq are not written
  const int64_t row_stride = static_cast<int64_t>(hq) * D;
  __nv_bfloat16* ob = o + static_cast<int64_t>(b) * sq * row_stride +
                      static_cast<int64_t>(h) * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a fully-masked row gives 0
    const int qr = q0 + r_lo + 8 * hr;
    // log-sum-exp in natural units for the backward (m_run is in log2
    // units); -inf for a row with no valid key
    if (lse != nullptr && (lane & 3) == 0 && qr < sq)
      lse[(static_cast<int64_t>(b) * hq + h) * sq + qr] =
          l > 0.f ? (m_run[hr] + log2f(l)) * 0.6931471805599453f : -INFINITY;
    if (qr < sq) {
      __nv_bfloat16* orow = ob + qr * row_stride;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int i = 4 * g + 2 * hr;
          *reinterpret_cast<uint32_t*>(orow + c * 64 + 8 * g + cq) =
              hopper::pack_bf16(acc[c][i] * inv, acc[c][i + 1] * inv);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// Returns a cudaError_t, or minus a CUresult if a tensor map fails to encode.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                 int b, int sq,
                 int sk, int hq, int hkv, const unsigned long long* geom,
                 float scale, int causal, int window, int q_offset, int device,
                 cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr size_t smem = wgmma_smem_bytes<D>();
  cudaError_t err = set_smem_once(flash_fwd_kernel_wgmma<D>, smem, device, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const CUresult r = hopper::encode_bf16_map(&maps[i], bases[i], geom + 11 * i);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  const dim3 grid(hq, b, (sq + kTile - 1) / kTile);
  flash_fwd_kernel_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, sq, sk, hq, hkv,
      scale * 1.4426950408889634f, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_simt(const void* q, const void* k, const void* v, void* o, float* lse,
                int b, int sq,
                int sk, int hq, int hkv, const long long* qs, const long long* ks,
                const long long* vs, float scale, int causal, int window,
                int q_offset, int device, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = set_smem_once(flash_fwd_kernel<T, D>, smem, device, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, hq, hkv, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, causal,
      window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_simt(int d, const void* q, const void* k, const void* v, void* o,
                  float* lse, int b, int sq, int sk, int hq, int hkv,
                  const long long* qs, const long long* ks, const long long* vs,
                  float scale, int causal, int window, int q_offset, int device,
                  cudaStream_t stream) {
#define REPRO_FLASH_CASE(DIM)                                                  \
  case DIM:                                                                    \
    return launch_simt<T, DIM>(q, k, v, o, lse, b, sq, sk, hq, hkv, qs, ks, vs, \
                               scale, causal, window, q_offset, device, stream);
  switch (d) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q/k/v strides are (batch, seq, head) in elements; the last dim is
// contiguous. dtype: 0 = float32, 1 = bfloat16. window <= 0 means none.
// The route is chosen by dtype and d alone: bf16 with d in {64, 128, 256}
// takes the tensor-core kernel, which needs `tma` (3 x 11 values: q's, k's
// and v's tensor-map dims, byte strides and box); everything else takes
// the SIMT kernel, which reads the strides and ignores `tma`.
// `lse` (or null): fp32 (b, hq, sq), each row's log-sum-exp of the scaled
// scores in natural units, -inf where no key is valid (the backward's
// input). Returns a cudaError_t (0 = ok), or minus a CUresult if a tensor
// map fails to encode.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
    int hq, int hkv, int d, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, int window,
    int q_offset, int dtype, const unsigned long long* tma, float* lse, int device,
    void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || sq <= 0 || hq <= 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (d == 64 || d == 128 || d == 256)) {
    if (tma == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    switch (d) {
      case 64:
        return launch_wgmma<64>(q, k, v, o, lse, b, sq, sk, hq, hkv, tma, scale, causal,
                                window, q_offset, device, s);
      case 128:
        return launch_wgmma<128>(q, k, v, o, lse, b, sq, sk, hq, hkv, tma, scale, causal,
                                 window, q_offset, device, s);
      default:
        return launch_wgmma<256>(q, k, v, o, lse, b, sq, sk, hq, hkv, tma, scale, causal,
                                 window, q_offset, device, s);
    }
  }
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  if (dtype == 0)
    return dispatch_simt<float>(d, q, k, v, o, lse, b, sq, sk, hq, hkv, qs, ks, vs, scale,
                                causal, window, q_offset, device, s);
  if (dtype == 1)
    return dispatch_simt<__nv_bfloat16>(d, q, k, v, o, lse, b, sq, sk, hq, hkv, qs, ks, vs,
                                        scale, causal, window, q_offset, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
