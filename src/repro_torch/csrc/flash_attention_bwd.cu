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
// Three launches, no atomics, so the result is deterministic:
// (a) `flash_bwd_dot_kernel`: D, one warp a (batch, query, head) row;
// (b) `flash_bwd_dkdv_kernel`: one block per (key tile, kv head, batch)
//     holds its K and V tiles and the dK and dV accumulators, and loops
//     over the group's n_rep query heads and the query tiles of the band,
//     so the GQA sum stays inside the block;
// (c) `flash_bwd_dq_kernel`: one block per (query tile, query head,
//     batch) loops over the key tiles of the band.
// (b) and (c) both recompute S and dP: seven products of s^2 d a head
// where five would do with dQ summed by atomics across key tiles.
//
// Bound on the H100: operations. This first kernel is SIMT fp32 (plain
// FMAs on tiles staged as fp32 in shared memory, fp32 accumulators in
// registers), for both fp32 and bf16 inputs; each of the 256 threads of a
// block computes a patch of each product from shared memory, which bounds
// it by shared-memory reads long before the FMA rate. Tiles are 64 x 64
// (32 x 32 for d = 256, whose fp32 tiles would not fit): 165 KB of dynamic
// shared memory at d = 128, 140 KB at d = 256. Gradients are written in the
// inputs' dtype.
//
// Layout: q, o, dO, dq (b, sq, hq, d); k, v, dk, dv (b, sk, hkv, d); all
// contiguous (the wrapper makes them so). lse and D are fp32 (b, hq, sq).
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (src/repro_torch/kernels/flash_attention/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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

// Query rows (BQ) and keys (BK) a tile, by head size.
template <int D>
struct Tile {
  static constexpr int BQ = D == 256 ? 32 : 64;
  static constexpr int BK = D == 256 ? 32 : 64;
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

  const int64_t rows = static_cast<int64_t>(b) * sq * hq;
  const unsigned int dot_blocks =
      static_cast<unsigned int>((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_dot_kernel<T><<<dot_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), gp, dvec, rows, sq, hq, D);
  err = cudaGetLastError();
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
    REPRO_FLASH_BWD_CASE(64)
    REPRO_FLASH_BWD_CASE(128)
    REPRO_FLASH_BWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BWD_CASE
}

}  // namespace

// All tensors contiguous: q, o, dout, dq (b, sq, hq, d); k, v, dk, dv
// (b, sk, hkv, d); lse (from flash_attention_fwd) and the scratch `dvec`
// fp32 (b, hq, sq). dtype: 0 = float32, 1 = bfloat16; window <= 0 means
// none. Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const float* lse,
                                   float* dvec, void* dq, void* dk, void* dv, int b,
                                   int sq, int sk, int hq, int hkv, int d, float scale,
                                   int causal, int window, int q_offset, int dtype,
                                   int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || sq <= 0 || sk <= 0 || hq <= 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
