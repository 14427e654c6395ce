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
// Backward (rmsnorm_bwd; the TPU kernels have none: the JAX package
// trains through its jnp norm): dx and dscale of the no-residual form, in
// the forward's launch shape, x and the output's gradient read once; the
// scale's gradient, a sum over rows, goes through per-block fp32 partial
// rows and a second small kernel that sums them in a fixed order, so it
// is deterministic and uses no atomics. Bound: bytes, as the forward.
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
constexpr int kBwdRegisterValues = 32;  // backward: values of each array a thread holds

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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Sums of two values over the `tpr` threads of a row; leaves `red` free for
// the next call.
__device__ __forceinline__ float2 row_sum2(float a, float b, int tpr, float2* red) {
  for (int off = (tpr < 32 ? tpr : 32) / 2; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (tpr > 32) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(a, b);
    __syncthreads();
    const int first = (threadIdx.x / tpr) * (tpr / 32);
    a = 0.f;
    b = 0.f;
    for (int w = 0; w < tpr / 32; ++w) {
      a += red[first + w].x;
      b += red[first + w].y;
    }
    __syncthreads();
  }
  return make_float2(a, b);
}

// With r = rsqrt(mean(x^2) + eps) and s the scale, both in fp32:
//   dx = r (g s) - x r^3 mean((g s) x)        in x's dtype,
//   dscale = sum over rows of g x r.
// The launch shape is the forward's (threads a row, vectors a thread).
// Block i takes row groups i, i + gridDim.x, ...; each row slot of a block
// sums its columns' g x r over its rows into one fp32 partial row
// (`partials`, gridDim.x * rows-a-block rows of d), which
// rmsnorm_dscale_kernel sums in a fixed order: deterministic, no atomics.
template <typename T, typename S, int VEC, int VPT>
__global__ void __launch_bounds__(kBlock)
rmsnorm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const S* __restrict__ scale, T* __restrict__ dx,
                   float* __restrict__ partials, int64_t rows, int d, int tpr,
                   float eps) {
  __shared__ float2 red[kBlock / 32];
  const int rpb = kBlock / tpr;
  const int t = threadIdx.x % tpr;
  const int slot = threadIdx.x / tpr;
  const int n_vec = (d + VEC - 1) / VEC;
  const int64_t groups = (rows + rpb - 1) / rpb;
  float* part = partials + (static_cast<int64_t>(blockIdx.x) * rpb + slot) * d;
  const float inv_d = 1.f / static_cast<float>(d);

  if constexpr (VPT > 0) {
    float sc[VPT][VEC], ds[VPT][VEC];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int iv = t + j * tpr;
      if (iv < n_vec) {
        load_f32(scale + iv * VEC, sc[j]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) sc[j][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ds[j][e] = 0.f;
    }
    for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
      const int64_t row = grp * rpb + slot;
      const bool live = row < rows;  // dead threads still join the reductions
      float xv[VPT][VEC], gv[VPT][VEC];
      float ss = 0.f, dot = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int iv = t + j * tpr;
        if (live && iv < n_vec) {
          load_f32(x + row * d + iv * VEC, xv[j]);
          load_f32(g + row * d + iv * VEC, gv[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[j][e] = gv[j][e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(xv[j][e], xv[j][e], ss);
          dot = fmaf(gv[j][e] * sc[j][e], xv[j][e], dot);
        }
      }
      const float2 tot = row_sum2(ss, dot, tpr, red);
      const float r = rsqrtf(tot.x * inv_d + eps);
      const float c = r * r * r * (tot.y * inv_d);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int iv = t + j * tpr;
        if (live && iv < n_vec) {
          float out[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            out[e] = r * (gv[j][e] * sc[j][e]) - xv[j][e] * c;
            ds[j][e] = fmaf(gv[j][e], xv[j][e] * r, ds[j][e]);
          }
          store_f32(dx + row * d + iv * VEC, out);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int iv = t + j * tpr;
      if (iv < n_vec) store_f32(part + iv * VEC, ds[j]);
    }
  } else {
    // a row longer than 16 vectors a thread: tpr = kBlock, one row a block;
    // the partial row in device memory is this block's alone
    bool first = true;
    for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
      float ss = 0.f, dot = 0.f;
      for (int iv = t; iv < n_vec; iv += tpr) {
        float xv[VEC], gv[VEC], sc[VEC];
        load_f32(x + row * d + iv * VEC, xv);
        load_f32(g + row * d + iv * VEC, gv);
        load_f32(scale + iv * VEC, sc);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ss = fmaf(xv[e], xv[e], ss);
          dot = fmaf(gv[e] * sc[e], xv[e], dot);
        }
      }
      const float2 tot = row_sum2(ss, dot, tpr, red);
      const float r = rsqrtf(tot.x * inv_d + eps);
      const float c = r * r * r * (tot.y * inv_d);
      for (int iv = t; iv < n_vec; iv += tpr) {
        float xv[VEC], gv[VEC], sc[VEC], out[VEC], acc[VEC];
        load_f32(x + row * d + iv * VEC, xv);
        load_f32(g + row * d + iv * VEC, gv);
        load_f32(scale + iv * VEC, sc);
        if (first) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
        } else {
          load_f32(part + iv * VEC, acc);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          out[e] = r * (gv[e] * sc[e]) - xv[e] * c;
          acc[e] = fmaf(gv[e], xv[e] * r, acc[e]);
        }
        store_f32(dx + row * d + iv * VEC, out);
        store_f32(part + iv * VEC, acc);
      }
      first = false;
    }
  }
}

// dscale[c] = the sum of the partial rows' column c, in a fixed order: each
// block takes 32 columns; its 8 warps' lanes sum partial rows w, w + 8, ...
// of their column, then one lane sums the 8 in order.
template <typename S>
__global__ void __launch_bounds__(kBlock)
rmsnorm_dscale_kernel(const float* __restrict__ partials, S* __restrict__ dscale,
                      int n_partial, int d) {
  __shared__ float red[kBlock / 32][33];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < d)
    for (int i = w; i < n_partial; i += kBlock / 32)
      acc += partials[static_cast<int64_t>(i) * d + c];
  red[w][lane] = acc;
  __syncthreads();
  if (w == 0 && c < d) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBlock / 32; ++i) sum += red[i][lane];
    dscale[c] = from_f32<S>(sum);
  }
}

template <typename T, typename S, int VEC>
cudaError_t launch_bwd_vec(const void* g, const void* x, const void* scale, void* dx,
                           void* dscale, float* partials, int64_t rows, int d, int tpr,
                           int vpt, int blocks, float eps, cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* dp = static_cast<T*>(dx);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  // a thread holds x, g, the scale and its dscale sums for VPT vectors:
  // beyond 32 values each the registers spill, and the wrapper
  // (ops.bwd_launch_shape) takes the looping form (VPT = 0) instead
#define REPRO_RMS_BWD_CASE(N)                                                      \
  case N:                                                                          \
    if constexpr (N * VEC <= kBwdRegisterValues) {                                 \
      rmsnorm_bwd_kernel<T, S, VEC, N><<<grid, kBlock, 0, stream>>>(               \
          gp, xp, sp, dp, partials, rows, d, tpr, eps);                            \
    } else {                                                                       \
      return cudaErrorInvalidValue;                                                \
    }                                                                              \
    break;
  switch (vpt) {
    REPRO_RMS_BWD_CASE(0)
    REPRO_RMS_BWD_CASE(1)
    REPRO_RMS_BWD_CASE(2)
    REPRO_RMS_BWD_CASE(4)
    REPRO_RMS_BWD_CASE(8)
    REPRO_RMS_BWD_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_RMS_BWD_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_partial = blocks * (kBlock / tpr);
  rmsnorm_dscale_kernel<S><<<(d + 31) / 32, kBlock, 0, stream>>>(
      partials, static_cast<S*>(dscale), n_partial, d);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* g, const void* x, const void* scale, void* dx,
                       void* dscale, float* partials, int64_t rows, int d, int vec,
                       int tpr, int vpt, int blocks, float eps, cudaStream_t stream) {
  if (tpr < 1 || tpr > kBlock || (tpr & (tpr - 1)) != 0 || blocks < 1)
    return cudaErrorInvalidValue;
  if (vpt == 0 && tpr != kBlock) return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return launch_bwd_vec<T, S, kVec>(g, x, scale, dx, dscale, partials, rows, d, tpr,
                                      vpt, blocks, eps, stream);
  if (vec == 1)
    return launch_bwd_vec<T, S, 1>(g, x, scale, dx, dscale, partials, rows, d, tpr, vpt,
                                   blocks, eps, stream);
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

// The gradient of rmsnorm_fwd without a residual: g (the output's
// gradient) and x (rows, d) in x_dtype, scale (d,) in scale_dtype; writes
// dx (rows, d) in x_dtype and dscale (d,) in scale_dtype. vec,
// threads_per_row and vectors_per_thread as ops.launch_shape chooses them
// for the forward; `blocks` blocks, each writing rows-a-block partial rows
// of d floats into `partials` (fp32 scratch of blocks * rows-a-block * d).
// Returns a cudaError_t (0 = ok).
extern "C" int rmsnorm_bwd(const void* g, const void* x, const void* scale, void* dx,
                           void* dscale, float* partials, long long rows, int d,
                           float eps, int x_dtype, int scale_dtype, int vec,
                           int threads_per_row, int vectors_per_thread, int blocks,
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
    err = launch_bwd<float, float>(g, x, scale, dx, dscale, partials, rows, d, vec, tpr,
                                   vpt, blocks, eps, s);
  else if (x_dtype == 0 && scale_dtype == 1)
    err = launch_bwd<float, __nv_bfloat16>(g, x, scale, dx, dscale, partials, rows, d,
                                           vec, tpr, vpt, blocks, eps, s);
  else if (x_dtype == 1 && scale_dtype == 0)
    err = launch_bwd<__nv_bfloat16, float>(g, x, scale, dx, dscale, partials, rows, d,
                                           vec, tpr, vpt, blocks, eps, s);
  else if (x_dtype == 1 && scale_dtype == 1)
    err = launch_bwd<__nv_bfloat16, __nv_bfloat16>(g, x, scale, dx, dscale, partials,
                                                   rows, d, vec, tpr, vpt, blocks, eps, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
