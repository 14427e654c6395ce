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
// trains through its jnp norm): dx and dscale of the no-residual form.
// Bound: bytes, as the forward (x and g read once, dx written once: 15.0
// us at gemma-2b's (4096, 2048) bf16). The first design loaded a row,
// reduced it across the block and stored it strictly in turn, one row a
// block at a time, and its dscale pass summed one partial row a row slot
// (4224 at the q-norm rows) on d / 32 blocks. So:
// * 512-thread blocks of 512 / tpr row slots (tpr as the forward's, or
//   half of it with two vectors a thread for rows of 129-256 vectors), each
//   thread copying its own vectors of the next `stages` - 1 rows of x and
//   g into a shared-memory ring by cp.async while it reduces the current
//   one; a row reduces by shuffles and one named barrier of its slot's
//   warps (no block barrier in the row loop);
// * the scale's gradient, a sum over rows, is summed inside a block
//   first (one fp32 partial row a block, slots in order), then across the
//   blocks' rows by a second kernel over d / 16 blocks of 16 columns, in a
//   fixed order: deterministic, no atomics;
// * the launch shape, the ring's depth and the block count are the
//   wrapper's (ops.bwd_launch_shape, bwd_blocks: three rows where they fit
//   96 KB a block, else one; one block an SM, the fastest in a sweep of
//   every shape at the training rows); scalar loads (VEC = 1) skip the
//   ring; a row too long for registers takes the looping form, one row a
//   block, read twice.
//
// Host cost a launch: the device is set only when it differs from the
// current one; nothing else runs on the host but the launch.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (src/repro_torch/kernels/fused_rmsnorm/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

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

constexpr int kBwdBlock = 512;         // threads a backward block
constexpr int kBwdMaxStages = 4;       // rows a thread keeps in flight
constexpr int kBwdMaxSmem = 128 << 10;  // bytes: ring, or the block's dscale rows

// Sums of two values over the `tpr` threads of a row (consecutive threads
// of the block); leaves `red` free for the next call. The looping form.
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

// Bytes of dynamic shared memory a backward block takes: the ring of
// `stages` rows of x and g a row slot (16-byte path), or the block's
// dscale rows (one a slot, one a warp where a warp holds several slots),
// whichever is larger.
template <typename T>
__host__ __device__ inline int bwd_smem_bytes(int d, int vec, int tpr, int vpt, int stages) {
  const int slots = kBwdBlock / tpr;
  const int ring = vec * static_cast<int>(sizeof(T)) == 16
                       ? stages * slots * 2 * tpr * vpt * 16 : 0;
  const int rows = kBwdBlock / (tpr < 32 ? 32 : tpr);
  const int sums = rows * d * static_cast<int>(sizeof(float));
  return ring > sums ? ring : sums;
}

// With r = rsqrt(mean(x^2) + eps) and s the scale, both in fp32:
//   dx = r (g s) - x r^3 mean((g s) x)        in x's dtype,
//   dscale = sum over rows of g x r.
// A block of 512 threads holds 512 / tpr row slots, `tpr` threads a row,
// VPT vectors of VEC elements a thread. Block i takes row groups i,
// i + gridDim.x, ...: slot j of a group is its row j. On the 16-byte path
// each thread copies its own vectors of x and g by cp.async into a ring
// of `stages` rows in shared memory, `stages` - 1 rows ahead of the one
// it reduces, so the bytes keep flowing while a row reduces; it reads
// back only what it copied, so no block barrier guards the ring. A row
// reduces by shuffles, then across the slot's warps through `red` (one
// named barrier, id 1 + slot, double-buffered by row parity). Each thread
// sums its columns' g x r over its rows; at the end the block sums its
// slots (warps first by shuffles, then slots in order) into one fp32
// partial row of `partials` (gridDim.x rows of d), which
// rmsnorm_dscale_kernel sums in a fixed order: deterministic, no atomics.
template <typename T, typename S, int VEC, int VPT>
__global__ void __launch_bounds__(kBwdBlock)
rmsnorm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const S* __restrict__ scale, T* __restrict__ dx,
                   float* __restrict__ partials, int64_t rows, int d, int tpr, int stages,
                   float eps) {
  extern __shared__ float4 smem4[];
  __shared__ float2 red[2][kBwdBlock / 32];
  constexpr bool kRing = VEC * sizeof(T) == 16;
  const int slots = kBwdBlock / tpr;
  const int t = threadIdx.x % tpr;
  const int slot = threadIdx.x / tpr;
  const int lane = threadIdx.x & 31;
  const int n_vec = (d + VEC - 1) / VEC;
  const int64_t groups = (rows + slots - 1) / slots;
  const int n_mine = blockIdx.x < groups
                         ? static_cast<int>((groups - 1 - blockIdx.x) / gridDim.x) + 1 : 0;
  const float inv_d = 1.f / static_cast<float>(d);
  // this slot's rows in the ring: [stage][slot][x, g][tpr * VPT vectors]
  T* ring = reinterpret_cast<T*>(smem4);
  const int ring_row = tpr * VPT * VEC;
  auto row_of = [&](int i) {
    return (static_cast<int64_t>(blockIdx.x) + static_cast<int64_t>(i) * gridDim.x) * slots +
           slot;
  };
  auto ring_x = [&](int i) { return ring + ((i % stages) * slots + slot) * 2 * ring_row; };
  // issue the copies of this thread's vectors of row group i (16-byte path)
  auto issue = [&](int i) {
    if (i < n_mine) {
      const int64_t row = row_of(i);
      const bool live = row < rows;
      T* sx = ring_x(i);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int iv = t + j * tpr;
        if (iv < n_vec) {
          const int64_t off = live ? row * d + iv * VEC : 0;
          hopper::cp_async16(hopper::smem_addr(sx + iv * VEC), x + off, live);
          hopper::cp_async16(hopper::smem_addr(sx + ring_row + iv * VEC), g + off, live);
        }
      }
    }
    hopper::cp_async_commit();
  };

  // the scale is read (from L1) where it is used, not held: with x, g and
  // the dscale sums at 32 values each, a fourth array would spill
  float ds[VPT][VEC];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) ds[j][e] = 0.f;
  if constexpr (kRing)
    for (int s = 0; s + 1 < stages; ++s) issue(s);
  for (int i = 0; i < n_mine; ++i) {
    const int64_t row = row_of(i);
    const bool live = row < rows;  // dead threads still join the reductions
    float xv[VPT][VEC], gv[VPT][VEC];
    if constexpr (kRing) {
      issue(i + stages - 1);
      hopper::cp_async_wait(stages - 1);  // this thread's copies of row i landed
      const T* sx = ring_x(i);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int iv = t + j * tpr;
        if (iv < n_vec) {  // a dead row was zero-filled
          load_f32(sx + iv * VEC, xv[j]);
          load_f32(sx + ring_row + iv * VEC, gv[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[j][e] = gv[j][e] = 0.f;
        }
      }
    } else {
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
      }
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (t + j * tpr >= n_vec) continue;
      float sc[VEC];
      load_f32(scale + (t + j * tpr) * VEC, sc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ss = fmaf(xv[j][e], xv[j][e], ss);
        dot = fmaf(gv[j][e] * sc[e], xv[j][e], dot);
      }
    }
    for (int off = (tpr < 32 ? tpr : 32) / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    if (tpr > 32) {
      float2* buf = red[i & 1];
      if (lane == 0) buf[threadIdx.x >> 5] = make_float2(ss, dot);
      hopper::bar_sync(1 + slot, tpr);
      const int first = slot * (tpr / 32);
      ss = 0.f;
      dot = 0.f;
      for (int w = 0; w < tpr / 32; ++w) {
        ss += buf[first + w].x;
        dot += buf[first + w].y;
      }
    }
    const float r = rsqrtf(ss * inv_d + eps);
    const float c = r * r * r * (dot * inv_d);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int iv = t + j * tpr;
      if (live && iv < n_vec) {
        float sc[VEC], out[VEC];
        load_f32(scale + iv * VEC, sc);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          out[e] = r * (gv[j][e] * sc[e]) - xv[j][e] * c;
          ds[j][e] = fmaf(gv[j][e], xv[j][e] * r, ds[j][e]);
        }
        store_f32(dx + row * d + iv * VEC, out);
      }
    }
  }
  if constexpr (kRing) hopper::cp_async_wait(0);

  // the block's partial row: a warp's slots summed by shuffles (lanes of
  // one column, in butterfly order), the slots' rows in order
  float* sums = reinterpret_cast<float*>(smem4);
  const int per_row = tpr < 32 ? 32 : tpr;
  const int n_rows = kBwdBlock / per_row;
  for (int off = tpr; off < 32; off <<= 1)
#pragma unroll
    for (int j = 0; j < VPT; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) ds[j][e] += __shfl_xor_sync(0xffffffffu, ds[j][e], off);
  __syncthreads();  // the ring is dead
  if (tpr >= 32 || lane < tpr) {
    float* mine = sums + static_cast<int64_t>(threadIdx.x / per_row) * d;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int iv = t + j * tpr;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (iv < n_vec) mine[iv * VEC + e] = ds[j][e];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kBwdBlock) {
    float sum = 0.f;
    for (int p = 0; p < n_rows; ++p) sum += sums[p * d + c];
    partials[static_cast<int64_t>(blockIdx.x) * d + c] = sum;
  }
}

// The looping form, for a row longer than the register path holds: one
// row a block (tpr = kBwdBlock), read twice; the block's partial row in
// device memory is its own.
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kBwdBlock)
rmsnorm_bwd_loop_kernel(const T* __restrict__ g, const T* __restrict__ x,
                        const S* __restrict__ scale, T* __restrict__ dx,
                        float* __restrict__ partials, int64_t rows, int d, float eps) {
  __shared__ float2 red[kBwdBlock / 32];
  const int t = threadIdx.x;
  const int n_vec = (d + VEC - 1) / VEC;
  float* part = partials + static_cast<int64_t>(blockIdx.x) * d;
  const float inv_d = 1.f / static_cast<float>(d);
  for (int iv = t; iv < n_vec; iv += kBwdBlock) {
    float zero[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) zero[e] = 0.f;
    store_f32(part + iv * VEC, zero);
  }
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    float ss = 0.f, dot = 0.f;
    for (int iv = t; iv < n_vec; iv += kBwdBlock) {
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
    const float2 tot = row_sum2(ss, dot, kBwdBlock, red);
    const float r = rsqrtf(tot.x * inv_d + eps);
    const float c = r * r * r * (tot.y * inv_d);
    for (int iv = t; iv < n_vec; iv += kBwdBlock) {
      float xv[VEC], gv[VEC], sc[VEC], out[VEC], acc[VEC];
      load_f32(x + row * d + iv * VEC, xv);
      load_f32(g + row * d + iv * VEC, gv);
      load_f32(scale + iv * VEC, sc);
      load_f32(part + iv * VEC, acc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        out[e] = r * (gv[e] * sc[e]) - xv[e] * c;
        acc[e] = fmaf(gv[e], xv[e] * r, acc[e]);
      }
      store_f32(dx + row * d + iv * VEC, out);
      store_f32(part + iv * VEC, acc);
    }
  }
}

// dscale[c] = the sum of the partial rows' column c, in a fixed order: a
// block takes 16 columns; its 16 row phases (a half-warp each) sum partial
// rows p, p + 16, ... of their column, then one thread a column sums the
// 16 in order. 16 columns a block: d / 16 blocks, 128 at d = 2048.
template <typename S>
__global__ void __launch_bounds__(256)
rmsnorm_dscale_kernel(const float* __restrict__ partials, S* __restrict__ dscale,
                      int n_partial, int d) {
  __shared__ float red[16][17];
  const int col = threadIdx.x & 15;
  const int phase = threadIdx.x >> 4;
  const int c = blockIdx.x * 16 + col;
  float acc = 0.f;
  if (c < d)
    for (int i = phase; i < n_partial; i += 16) acc += partials[static_cast<int64_t>(i) * d + c];
  red[phase][col] = acc;
  __syncthreads();
  if (threadIdx.x < 16 && c < d) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) sum += red[i][col];
    dscale[c] = from_f32<S>(sum);
  }
}

// cudaFuncSetAttribute for a kernel's dynamic shared memory beyond 48 KB,
// once a device (a bit of `done` each).
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int device, std::atomic<uint64_t>& done) {
  const uint64_t bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, typename S, int VEC, int VPT>
cudaError_t launch_bwd_slots(const T* g, const T* x, const S* scale, T* dx,
                             float* partials, int64_t rows, int d, int tpr, int stages,
                             int blocks, int device, float eps, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t err = set_smem_once(rmsnorm_bwd_kernel<T, S, VEC, VPT>, device, smem_set);
  if (err != cudaSuccess) return err;
  const int smem = bwd_smem_bytes<T>(d, VEC, tpr, VPT, stages);
  rmsnorm_bwd_kernel<T, S, VEC, VPT><<<blocks, kBwdBlock, smem, stream>>>(
      g, x, scale, dx, partials, rows, d, tpr, stages, eps);
  return cudaGetLastError();
}

template <typename T, typename S, int VEC>
cudaError_t launch_bwd_vec(const void* g, const void* x, const void* scale, void* dx,
                           void* dscale, float* partials, int64_t rows, int d, int tpr,
                           int vpt, int stages, int blocks, int device, float eps,
                           cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* dp = static_cast<T*>(dx);
  cudaError_t err = cudaSuccess;
  // a thread holds x, g, the scale and its dscale sums for VPT vectors:
  // beyond 32 values each the registers spill, and the wrapper
  // (ops.bwd_launch_shape) takes the looping form (VPT = 0) instead
#define REPRO_RMS_BWD_CASE(N)                                                           \
  case N:                                                                               \
    if constexpr (N * VEC <= kBwdRegisterValues) {                                      \
      err = launch_bwd_slots<T, S, VEC, N>(gp, xp, sp, dp, partials, rows, d, tpr, stages, \
                                           blocks, device, eps, stream);                \
    } else {                                                                            \
      return cudaErrorInvalidValue;                                                     \
    }                                                                                   \
    break;
  switch (vpt) {
    case 0:
      rmsnorm_bwd_loop_kernel<T, S, VEC><<<blocks, kBwdBlock, 0, stream>>>(
          gp, xp, sp, dp, partials, rows, d, eps);
      err = cudaGetLastError();
      break;
    REPRO_RMS_BWD_CASE(1)
    REPRO_RMS_BWD_CASE(2)
    REPRO_RMS_BWD_CASE(4)
    REPRO_RMS_BWD_CASE(8)
    REPRO_RMS_BWD_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_RMS_BWD_CASE
  if (err != cudaSuccess) return err;
  rmsnorm_dscale_kernel<S><<<(d + 15) / 16, 256, 0, stream>>>(
      partials, static_cast<S*>(dscale), blocks, d);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* g, const void* x, const void* scale, void* dx,
                       void* dscale, float* partials, int64_t rows, int d, int vec,
                       int tpr, int vpt, int stages, int blocks, int device, float eps,
                       cudaStream_t stream) {
  if (tpr < 1 || tpr > kBwdBlock || (tpr & (tpr - 1)) != 0 || blocks < 1)
    return cudaErrorInvalidValue;
  if (vpt == 0 && tpr != kBwdBlock) return cudaErrorInvalidValue;
  if (vpt > 0 && (stages < 1 || stages > kBwdMaxStages ||
                  bwd_smem_bytes<T>(d, vec, tpr, vpt, stages) > kBwdMaxSmem ||
                  static_cast<int64_t>(tpr) * vpt * vec < d))
    return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    return launch_bwd_vec<T, S, kVec>(g, x, scale, dx, dscale, partials, rows, d, tpr, vpt,
                                      stages, blocks, device, eps, stream);
  if (vec == 1)
    return launch_bwd_vec<T, S, 1>(g, x, scale, dx, dscale, partials, rows, d, tpr, vpt,
                                   stages, blocks, device, eps, stream);
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
// threads_per_row, vectors_per_thread and stages as ops.bwd_launch_shape
// chooses them (vectors_per_thread = 0: the looping form, threads_per_row
// = 512); `blocks` blocks, each writing one partial row of d floats into
// `partials` (fp32 scratch of blocks * d). Returns a cudaError_t (0 = ok).
extern "C" int rmsnorm_bwd(const void* g, const void* x, const void* scale, void* dx,
                           void* dscale, float* partials, long long rows, int d,
                           float eps, int x_dtype, int scale_dtype, int vec,
                           int threads_per_row, int vectors_per_thread, int stages,
                           int blocks, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tpr = threads_per_row;
  const int vpt = vectors_per_thread;
#define REPRO_RMS_BWD(T, S)                                                                \
  launch_bwd<T, S>(g, x, scale, dx, dscale, partials, rows, d, vec, tpr, vpt, stages, blocks, \
                   device, eps, s)
  if (x_dtype == 0 && scale_dtype == 0)
    err = REPRO_RMS_BWD(float, float);
  else if (x_dtype == 0 && scale_dtype == 1)
    err = REPRO_RMS_BWD(float, __nv_bfloat16);
  else if (x_dtype == 1 && scale_dtype == 0)
    err = REPRO_RMS_BWD(__nv_bfloat16, float);
  else if (x_dtype == 1 && scale_dtype == 1)
    err = REPRO_RMS_BWD(__nv_bfloat16, __nv_bfloat16);
  else
    err = cudaErrorInvalidValue;
#undef REPRO_RMS_BWD
  return static_cast<int>(err);
}
