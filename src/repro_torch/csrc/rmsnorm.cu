// RMSNorm with an optional fused residual add, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_rmsnorm_kernel` and
// `_rmsnorm_residual_kernel` of src/repro/kernels/fused_rmsnorm/kernel.py:
//   y = x' * rsqrt(mean(x'^2) + eps) * scale,   x' = x (+ residual)
// with fp32 statistics, the residual added after the upcast to fp32, and
// the output in x's dtype. Only the normed tensor is returned.
//
// Bound on the H100: bytes. Each element is read once (twice with the
// residual) and written once, a handful of fp32 operations apiece, far
// below the card's operations-per-byte line. So the design reads each row
// from device memory once, in 16-byte vectors:
//
// * A row is spread over `tpr` threads (a power of two up to 256), each
//   holding VPT vectors of VEC elements in registers: VEC = 8 for bf16,
//   4 for fp32 (16 bytes). At d = 4096 bf16 that is 256 threads a row with
//   two vectors each; at d = 128 bf16 a half-warp a row. Rows share a
//   256-thread block when tpr < 256.
// * The sum of squares is reduced with warp shuffles, then across the
//   row's warps in shared memory; the second pass scales the registers,
//   never re-reading x or the residual. Scale and residual are loaded in
//   vectors of the same shape.
// * Documented other paths of the same kernel, chosen by shape and
//   alignment (kernels/fused_rmsnorm/ops.py::launch_shape), never on
//   failure: VEC = 1 (scalar loads) when d is not a multiple of the vector
//   width or a pointer is not 16-byte aligned; VPT = 0 (a loop over the
//   row that reads it twice) when a row does not fit 16 vectors a thread.
//
// Host cost a launch: the device is set only when it differs from the
// current one; nothing else runs on the host but the launch.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (src/repro_torch/kernels/fused_rmsnorm/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads a block

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
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// N elements of T moved as one access (two for 32 bytes of fp32 scale).
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_f32(pk.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_f32(T* p, const float (&f)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) pk.v[i] = from_f32<T>(f[i]);
  *reinterpret_cast<Pack<T, N>*>(p) = pk;
}

// Sum over the `tpr` threads of a row (consecutive threads of the block).
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  for (int off = (tpr < 32 ? tpr : 32) / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (tpr > 32) {  // uniform across the block; the row's warps are consecutive
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    const int first = (threadIdx.x / tpr) * (tpr / 32);
    v = 0.f;
    for (int w = 0; w < tpr / 32; ++w) v += red[first + w];
  }
  return v;
}

// VEC elements a vector, VPT vectors a thread held in registers (VPT = 0:
// loop over the row and read it twice).
template <typename T, typename S, int VEC, int VPT>
__global__ void __launch_bounds__(kBlock)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ residual,
               const S* __restrict__ scale, T* __restrict__ out, int64_t rows,
               int d, int tpr, float eps) {
  __shared__ float red[kBlock / 32];
  const int t = threadIdx.x % tpr;  // thread within the row
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kBlock / tpr) + threadIdx.x / tpr;
  const bool live = row < rows;  // dead threads still join the reductions
  const int n_vec = (d + VEC - 1) / VEC;
  const T* xr = x + row * d;
  const T* rr = residual != nullptr ? residual + row * d : nullptr;
  T* orow = out + row * d;

  float ss = 0.f;
  if constexpr (VPT > 0) {
    float v[VPT][VEC];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int iv = t + j * tpr;
      if (live && iv < n_vec) {
        load_f32(xr + iv * VEC, v[j]);
        if (rr != nullptr) {
          float r[VEC];
          load_f32(rr + iv * VEC, r);
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[j][e] += r[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[j][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(v[j][e], v[j][e], ss);
    }
    const float inv = rsqrtf(row_sum(ss, tpr, red) / static_cast<float>(d) + eps);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int iv = t + j * tpr;
      if (live && iv < n_vec) {
        float sc[VEC];
        load_f32(scale + iv * VEC, sc);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[j][e] = v[j][e] * inv * sc[e];
        store_f32(orow + iv * VEC, v[j]);
      }
    }
  } else {
    for (int iv = t; live && iv < n_vec; iv += tpr) {
      float v[VEC];
      load_f32(xr + iv * VEC, v);
      if (rr != nullptr) {
        float r[VEC];
        load_f32(rr + iv * VEC, r);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] += r[e];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(v[e], v[e], ss);
    }
    const float inv = rsqrtf(row_sum(ss, tpr, red) / static_cast<float>(d) + eps);
    for (int iv = t; live && iv < n_vec; iv += tpr) {
      float v[VEC], sc[VEC];
      load_f32(xr + iv * VEC, v);
      if (rr != nullptr) {
        float r[VEC];
        load_f32(rr + iv * VEC, r);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] += r[e];
      }
      load_f32(scale + iv * VEC, sc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = v[e] * inv * sc[e];
      store_f32(orow + iv * VEC, v);
    }
  }
}

template <typename T, typename S, int VEC>
cudaError_t launch_vec(const void* x, const void* residual, const void* scale,
                       void* out, int64_t rows, int d, int tpr, int vpt, float eps,
                       cudaStream_t stream) {
  const int64_t blocks = (rows + kBlock / tpr - 1) / (kBlock / tpr);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(residual);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  const unsigned int grid = static_cast<unsigned int>(blocks);
#define REPRO_RMS_CASE(N)                                                    \
  case N:                                                                    \
    rmsnorm_kernel<T, S, VEC, N><<<grid, kBlock, 0, stream>>>(xp, rp, sp, op, \
                                                              rows, d, tpr, eps); \
    break;
  switch (vpt) {
    REPRO_RMS_CASE(0)
    REPRO_RMS_CASE(1)
    REPRO_RMS_CASE(2)
    REPRO_RMS_CASE(4)
    REPRO_RMS_CASE(8)
    REPRO_RMS_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_RMS_CASE
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* residual, const void* scale, void* out,
                   int64_t rows, int d, int vec, int tpr, int vpt, float eps,
                   cudaStream_t stream) {
  if (tpr < 1 || tpr > kBlock || (tpr & (tpr - 1)) != 0) return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return launch_vec<T, S, kVec>(x, residual, scale, out, rows, d, tpr, vpt, eps,
                                  stream);
  if (vec == 1)
    return launch_vec<T, S, 1>(x, residual, scale, out, rows, d, tpr, vpt, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. vec (elements a vector: 16 bytes'
// worth, or 1), threads_per_row and vectors_per_thread as
// ops.launch_shape chooses them. Returns a cudaError_t (0 = ok).
extern "C" int rmsnorm_fwd(const void* x, const void* residual,
                           const void* scale, void* out, long long rows, int d,
                           float eps, int x_dtype, int scale_dtype, int vec,
                           int threads_per_row, int vectors_per_thread,
                           int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tpr = threads_per_row;
  const int vpt = vectors_per_thread;
  if (x_dtype == 0 && scale_dtype == 0)
    err = launch<float, float>(x, residual, scale, out, rows, d, vec, tpr, vpt, eps, s);
  else if (x_dtype == 0 && scale_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, residual, scale, out, rows, d, vec, tpr, vpt,
                                       eps, s);
  else if (x_dtype == 1 && scale_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, residual, scale, out, rows, d, vec, tpr, vpt,
                                       eps, s);
  else if (x_dtype == 1 && scale_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, residual, scale, out, rows, d, vec,
                                               tpr, vpt, eps, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
