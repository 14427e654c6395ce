// PTX wrappers for Hopper (sm_90a) that the port's kernels build on:
// mbarriers, TMA tensor loads into shared memory and warpgroup matrix
// multiplies (wgmma) on 128-byte-swizzled shared-memory tiles (flash
// attention); cp.async copies (WKV6, the fp32 flash-attention backward,
// the RMSNorm backward), TF32 rounding, ex2 and lg2, and warp-level TF32
// mma.sync (WKV6) with its 3xTF32 form (the fp32 flash-attention
// backward).
//
// Shared-memory addresses are 32-bit offsets in the shared window
// (`smem_addr`), as TMA, mbarrier and wgmma take them.
//
// Host side: the bf16 TMA tensor-map encoder both flash-attention files
// use (`encode_bf16_map`), through the driver entry point the runtime
// looks up once (the library does not link libcuda).

#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); follow
// with __syncthreads() before any thread uses them.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, and `bytes` more expected from TMA before the phase flips.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with the given parity has completed. A
// phase that never completes (a lost TMA transaction is a fault) traps
// after ~2^28 tries, seconds, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Copy the box at coordinates (c0 innermost .. c3) of a rank-4 tensor map
// into shared memory at `dst`; completion is counted in bytes on `bar`.
// Out-of-bounds elements of the box arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) of contiguous
// global memory into shared memory at `dst`; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor for a 128-byte-swizzled tile (layout type
// 1 in bits 62-63), offsets in bytes. The tile must sit at a 1024-byte
// boundary, where TMA's swizzle pattern starts, so the base offset is 0;
// advancing `addr` by 32 bytes steps 16 bf16 along a K-major row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most one committed group is still in flight (the older
// ones are done).
__device__ __forceinline__ void wgmma_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two fp32 values as one register of two bf16 (`lo` in the low half), the
// operand order of a wgmma A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], fp32 accumulate, A and B bf16
// from shared memory, both K-major. scale_d = 0 ignores d's input.
//
// Accumulator layout (warpgroup thread t, warp w = t / 32, lane l): d[i]
// holds row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A bf16 from registers (four
// registers of two bf16 a thread: rows 16 w + l / 4 and +8, columns
// 2 (l % 4) and +8, in the order (r, c), (r+8, c), (r, c+8), (r+8, c+8)),
// B bf16 from shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// named barriers (id 0 is __syncthreads)
// ---------------------------------------------------------------------------

// Wait until `n` threads (a multiple of 32) have arrived at barrier `id`;
// the shared-memory writes of the arriving threads are then visible.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Arrive at barrier `id` of `n` threads without waiting.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

// Copy 16 bytes (16-byte aligned at both ends) or 4 bytes from global to
// shared memory without passing through registers. With `live` false
// nothing is read and the destination is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for every committed group of this thread; follow with
// __syncthreads() before reading another thread's copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most `pending` (0-3, uniform) of this thread's committed
// groups are still in flight: the older ones have landed.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// ---------------------------------------------------------------------------
// TF32 mma.sync
// ---------------------------------------------------------------------------

// fp32 rounded to TF32 (10-bit mantissa, round to nearest, ties away from
// zero), as the bits of an fp32 whose low 13 bits are zero: for finite x
// what cvt.rna.tf32.f32 returns, in two integer instructions (the cvt
// takes four on sm_90a). Adding half the dropped ulp to the magnitude
// bits carries into the kept ones exactly when rna rounds up.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// 2^x on the special-function unit (2 ulp; subnormal results flush to 0,
// 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d[16 x 8] += A[16 x 8] * B[8 x 8], TF32 operands, fp32 accumulate. For
// lane l, g = l / 4 and q = l % 4 (PTX ISA, mma.m16n8k8 .tf32 fragments;
// CUTLASS's SM80_16x8x8_F32TF32TF32F32_TN traits):
//   a[0] = A[g][q], a[1] = A[g+8][q], a[2] = A[g][q+4], a[3] = A[g+8][q+4]
//   b[0] = B[q][g], b[1] = B[q+4][g]
//   d[0] = D[g][2q], d[1] = D[g][2q+1], d[2] = D[g+8][2q], d[3] = D[g+8][2q+1]
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: an fp32 operand as two TF32 parts, x = big + small to ~2^-22
// relative (big = tf32(x), small = tf32(x - big)), and the product
// big*big + big*small + small*big in fp32 (the small*small term, ~2^-22
// relative, is dropped), which keeps an fp32 product's accuracy on the
// tensor cores. N fragment registers a part (A: 4, B: 2).
template <int N>
struct Tf32Split {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    big[i] = tf32(x);
    small[i] = tf32(x - __uint_as_float(big[i]));
  }
};

// d += a b in 3xTF32 into one accumulator, the two small terms first.
__device__ __forceinline__ void mma_m16n8k8_3xtf32(float (&d)[4], const Tf32Split<4>& a,
                                                   const Tf32Split<2>& b) {
  mma_m16n8k8_tf32(d, a.small, b.big);
  mma_m16n8k8_tf32(d, a.big, b.small);
  mma_m16n8k8_tf32(d, a.big, b.big);
}

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, looked up once;
// null if the driver does not have it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-4 bf16 map, 128-byte swizzle, zero fill out of bounds. geom:
// dims[4] (innermost first), byte strides[3], box[4] — as the wrapper's
// ops.tma_geometry computes them. Returns a CUresult.
inline CUresult encode_bf16_map(CUtensorMap* map, const void* base,
                                const unsigned long long* geom) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {geom[0], geom[1], geom[2], geom[3]};
  const cuuint64_t strides[3] = {geom[4], geom[5], geom[6]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(geom[7]),
                             static_cast<cuuint32_t>(geom[8]),
                             static_cast<cuuint32_t>(geom[9]),
                             static_cast<cuuint32_t>(geom[10])};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace hopper
