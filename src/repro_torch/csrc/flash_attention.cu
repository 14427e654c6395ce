// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention/kernel.py: online-softmax attention
// with fp32 running max / sum / accumulator, GQA (query head h reads kv
// head h / n_rep, no KV duplication), causal and sliding-window masks with
// a query offset, key tiles outside the band skipped, fully-masked rows
// giving 0, output in the input dtype.
//
// Bound on the H100: operations. At the model's shapes (s = 2048, d = 128)
// attention does ~2 * 2 * s * s/2 * d operations per head against ~4 * s * d
// elements moved, far above the card's operations-per-byte line. This
// first version is SIMT fp32 (no tensor cores): plain FMA keeps fp32
// results within 2e-5 of the fp32 reference (TF32 would not), and the
// same code serves bf16 inputs, which are widened to fp32 in shared
// memory. So it runs at most at the 67 TFLOP/s fp32 rate, not the
// 989 TFLOP/s of bf16 wgmma; the tensor-core version is later work.
//
// Design. One 256-thread block per (64-query tile, query head, batch).
// The TPU kernel's sequential k-block grid axis becomes a loop inside the
// block over the live 64-key tiles of the band only, so the causal and
// window skip is kept. Per key tile: K is staged in shared memory, each
// thread computes a 4x4 patch of the 64x64 score tile, warps run the
// online-softmax update row by row with shuffles, then V replaces K in the
// same buffer and each thread accumulates a 4 x (d/16) patch of the output
// in registers. Tiles are fp32 with rows padded by one word, so column
// walks hit distinct banks. For d = 256 that is ~146 KB of shared memory,
// above the 48 KB static limit: the kernel uses dynamic shared memory
// after cudaFuncSetAttribute(MaxDynamicSharedMemorySize).
//
// Layout: q (b, sq, hq, d), k/v (b, sk, hkv, d) as the model holds them;
// the kernel takes the batch/sequence/head strides, so no transpose or
// copy is needed, and requires the last dimension to be contiguous. The
// output is written contiguous (b, sq, hq, d).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int sk, int hq, int hkv, const long long* qs,
                   const long long* ks, const long long* vs, float scale,
                   int causal, int window, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, hq, hkv, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, causal,
      window, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int b, int sq, int sk, int hq, int hkv,
                       const long long* qs, const long long* ks,
                       const long long* vs, float scale, int causal, int window,
                       int q_offset, cudaStream_t stream) {
#define REPRO_FLASH_CASE(DIM)                                                  \
  case DIM:                                                                    \
    return launch<T, DIM>(q, k, v, o, b, sq, sk, hq, hkv, qs, ks, vs, scale,   \
                          causal, window, q_offset, stream);
  switch (d) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

// q/k/v strides are (batch, seq, head) in elements; the last dim is
// contiguous. dtype: 0 = float32, 1 = bfloat16. window <= 0 means none.
// Returns a cudaError_t (0 = ok).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
    int hq, int hkv, int d, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, int window,
    int q_offset, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || sq <= 0 || hq <= 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_d<float>(d, q, k, v, o, b, sq, sk, hq, hkv, qs, ks, vs,
                            scale, causal, window, q_offset, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, sq, sk, hq, hkv, qs, ks,
                                    vs, scale, causal, window, q_offset, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
