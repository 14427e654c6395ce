// RMSNorm with an optional fused residual add, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_rmsnorm_kernel` and
// `_rmsnorm_residual_kernel` of src/repro/kernels/fused_rmsnorm/kernel.py:
//   y = x' * rsqrt(mean(x'^2) + eps) * scale,   x' = x (+ residual)
// with fp32 statistics, the residual added after the upcast to fp32, and
// the output in x's dtype. Only the normed tensor is returned.
//
// Bound on the H100: bytes. Each element is read once (twice with the
// residual) and written once, a handful of fp32 operations apiece, so the
// kernel sits far below the card's ~20 operations per byte of fp32 ALU
// rate over HBM bandwidth. Design: one warp per row, eight rows per
// 256-thread block; the row's sum of squares is reduced with warp
// shuffles in fp32, so no shared memory and no second launch. The second
// pass re-reads the row, which a warp has just touched, from L1/L2 rather
// than HBM. Rows are masked in the kernel, so any row count works; d may
// be anything (the model uses 128, 2048 and 4096). Loads are scalar: 16-byte
// vector loads are left for a later, faster version.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (src/repro_torch/kernels/fused_rmsnorm/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

template <typename T, typename S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ residual,
               const S* __restrict__ scale, T* __restrict__ out,
               int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* xr = x + row * d;
  const T* rr = residual != nullptr ? residual + row * d : nullptr;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    float v = to_f32(xr[i]);
    if (rr != nullptr) v += to_f32(rr[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = lane; i < d; i += 32) {
    float v = to_f32(xr[i]);
    if (rr != nullptr) v += to_f32(rr[i]);
    orow[i] = from_f32<T>(v * inv * to_f32(scale[i]));
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* residual, const void* scale,
                   void* out, int64_t rows, int d, float eps,
                   cudaStream_t stream) {
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T, S><<<static_cast<unsigned int>(blocks),
                         kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(residual),
      static_cast<const S*>(scale), static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = ok).
extern "C" int rmsnorm_fwd(const void* x, const void* residual,
                           const void* scale, void* out, long long rows, int d,
                           float eps, int x_dtype, int scale_dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0)
    err = launch<float, float>(x, residual, scale, out, rows, d, eps, s);
  else if (x_dtype == 0 && scale_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, residual, scale, out, rows, d, eps, s);
  else if (x_dtype == 1 && scale_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, residual, scale, out, rows, d, eps, s);
  else if (x_dtype == 1 && scale_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, residual, scale, out, rows, d,
                                               eps, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
