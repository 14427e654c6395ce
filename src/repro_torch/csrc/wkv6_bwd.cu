// WKV6 backward (B3) for Hopper (sm_90a): the gradients of K4's outputs.
//
// The backward of csrc/wkv6.cu (K4, which replaces the Pallas TPU kernel
// `_wkv_kernel` of src/repro/kernels/rwkv_scan/kernel.py; the TPU package
// differentiates through its jnp oracle and has no backward kernel). The
// forward per (batch, head), in fp32,
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t,   S_{-1} = s0 (or 0),
// has, with G_t the cotangent of S_t (G_{T-1} = dS_T, the final state's),
//     G_{t-1}   = diag(w_t) G_t + r_t^T do_t            (ds0 = G_{-1})
//     dr_t[c]   = sum_j do_t[j] (S_{t-1}[c,j] + u[c] k_t[c] v_t[j])
//     dk_t[c]   = sum_j v_t[j] (G_t[c,j] + r_t[c] u[c] do_t[j])
//     dv_t[j]   = sum_c k_t[c] (G_t[c,j] + r_t[c] u[c] do_t[j])
//     dw_t[c]   = sum_j G_t[c,j] S_{t-1}[c,j]
//     du[c]     = sum_{b,t} r_t[c] k_t[c] sum_j do_t[j] v_t[j].
// dw is that product of the state and its cotangent, never d log w / w or
// a reverse cumulative sum of differences (the usual chunked form, which
// cancels when w is tiny and is 0/0 at w = 0): decays of 0 and below K4's
// e^-60 floor give finite gradients. S is never recovered backwards as
// (S_t - k_t^T v_t) / w_t either (that division blows up for fast decays).
//
// Design: the sequence is cut into chunks of kChunk = 32 steps, and the
// work into three launches.
//   A, B (one launch, wkv6_bwd_bound_kernel): the state at every chunk's
//     start (A, first chunk to last, from s0) and the cotangent at every
//     chunk's end (B, last to first, from dS_T), written to the workspace,
//     by K4's closed form over a chunk (cum[t] = sum_{i<=t} log w_i per
//     channel, cum_prev[t] = cum[t-1], 0 at t = 0):
//         S_next  = e^{cum[L-1]} S + sum_t (k_t e^{cum[L-1] - cum[t]})^T v_t
//         G_start = e^{cum[L-1]} G_end + sum_t (r_t e^{cum_prev[t]})^T do_t
//     (G_start is the cotangent of the chunk's start state; ds0 is the
//     first chunk's). As in K4: logs are log2f with log w floored at -60
//     (w at e^-60), every exponent a non-positive difference clamped at 0,
//     the products (rows x L)(L x dv) 3xTF32 mma.sync m16n8k8 with the
//     big*big and small terms in separate accumulators, and rows past a
//     ragged last chunk's end zero-filled with log w = 0 (they do nothing).
//     A block takes one (pass, 16 state rows, head, batch), so each block
//     takes the logs and decays of its own 16 channels only: 8 blocks a
//     (batch, head) at dk = 64, 512 at rwkv6-7b's 64 heads. The chain of
//     chunks is a loop, the next chunk's tiles copied by cp.async into the
//     other of two stages; a chunk step's prefix sum is a warp scan over
//     the lanes of a channel (shuffles), so a step has two barriers.
//   C (wkv6_bwd_chunk_kernel): every chunk in parallel, a block a (chunk,
//     head, batch): 8,192 blocks at (1, 4096) with 64 heads. Thread
//     (row c, column group jg) holds kCols = 8 columns of row c of S and
//     G in registers: dk dv / 8 threads, 512 (16 warps, one block an SM)
//     at 64 x 64. From the chunk's start state, a forward walk writes a
//     checkpoint of S every kSeg = 4 steps to shared memory (each thread
//     its own 8 floats); then the segments last to first: S_{t-1} of the
//     segment's steps are recomputed into registers (dr, and the row's part
//     of du, from them), and G, from the chunk's end cotangent, walks back
//     through them giving dk, dw and dv. Every step is the plain recurrence
//     in fp32, with w as given. A walk keeps its results in registers and
//     stores them after its last step, and a full segment has no branch
//     between its steps, so one step's loads overlap the last one's
//     shuffles.
//   du (wkv6_bwd_du_kernel): each pass C block writes its chunk's part of
//     du; the parts are summed in (batch, chunk) order.
// Sums: a row's dr, dk, dw over its dv / 8 lanes by xor shuffles (the upper
// half of the lanes keeps dw, the lower dk); dv over a warp's rows by a
// reduce-scatter of shuffles, then over the warps in warp order in shared
// memory. Chunks own disjoint steps, so every output is written once; no
// atomics, and a call repeats bit for bit.
//
// Tried on the card and dropped (PERF.md): pass C as a cluster of
// two blocks, each half the state rows and dv summed through distributed
// shared memory (two blocks an SM, slower); pass C copying r and do
// while its checkpoint walk runs (no change); a third copy stage and whole
// heads a block in A and B (no change: the chain is bound by instruction
// issue, not by memory).
//
// Bound on the H100: operations. A token and head take six multiply-adds a
// state element (S recomputed, G, dr, dk, dv, dw): 12 dk dv operations,
// against 4 (6 dk + 3 dv) bytes read and written once (r, k, w, v, do in;
// dr, dk, dw, dv out). At dk = dv = 64 that is 21 operations a byte, just
// above the fp32 line (67e12 / 3.35e12 = 20); chip_smoke.py times it
// against that bound. The walks make S twice (the checkpoint walk and the
// recompute): 11 fp32 operations a state element and step, and ~4.5 more
// instructions of shuffles and selects for the sums.
//
// Layout: r, k, w (b, s, h, dk) and v (b, s, h, dv) as K4 reads them,
// through their batch/sequence/head strides with the last dimension
// contiguous; do (b, s, h, dv), dS_T and s0 (b, h, dk, dv), u (h, dk)
// contiguous. dr, dk, dw (b, s, h, dk), dv (b, s, h, dv), du (h, dk) and
// ds0 (b, h, dk, dv) are written contiguous. do, dS_T, s0 and ds0 may be
// null (a zero cotangent, a zero initial state, no ds0). The workspace
// holds the states and cotangents, (b, chunks, h, dk, dv) each, 134 MB
// each at (1, 4096) with 64 heads of 64, and du's parts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 32;  // steps a chunk: a state and a cotangent at each boundary
constexpr int kSeg = 4;     // steps a pass C segment: a checkpoint of S at each start
constexpr int kCols = 8;    // state columns a pass C thread holds
constexpr int kMaxDim = 64;
constexpr int kBoundThreads = 128;
constexpr int kBoundRows = 16;  // state rows a bound-kernel block (the mma's M)
constexpr int kSumThreads = 256;
constexpr float kLog2E = 1.4426950408889634f;
constexpr float kLog2Floor = -60.f * kLog2E;  // log w >= -60
constexpr float kWFloor = 8.75651076e-27f;     // e^-60, the same floor on w
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;      // or null
  const float* dout;    // or null
  const float* dstate;  // or null
  float* gr;
  float* gk;
  float* gv;
  float* gw;
  float* gs0;      // or null
  float* states;   // (b, chunks, h, dk, dv): S at each chunk's start
  float* cots;     // (b, chunks, h, dk, dv): G at each chunk's end
  float* gu_part;  // (b, chunks, h, dk)
  int s_len, h, dk, dv, nchunk, vec4;
  long long r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh;
};

// e^(x ln 2) for an exponent that is <= 0 in exact arithmetic
__device__ __forceinline__ float decay2(float x) { return hopper::exp2_approx(fminf(x, 0.f)); }

// Rows [0, kChunk) of `cols` floats from rows `row_stride` apart into
// shared memory (row stride ld) by `nthreads` threads, 16-byte copies
// (vec4) or 4-byte ones; rows at or past `live` are zero-filled.
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* src,
                                           long long row_stride, int cols, int live, bool vec4,
                                           int tid, int nthreads) {
  const int width = vec4 ? 4 : 1;
  const int per_row = cols / width, shift = __ffs(per_row) - 1;  // cols: a power of two
  for (int idx = tid; idx < kChunk * per_row; idx += nthreads) {
    const int t = idx >> shift;
    const int c = (idx & (per_row - 1)) * width;
    const bool on = t < live;
    const float* from = on ? src + t * row_stride + c : src;
    const uint32_t to = hopper::smem_addr(dst + t * ld + c);
    if (vec4)
      hopper::cp_async16(to, from, on);
    else
      hopper::cp_async4(to, from, on);
  }
}

// ---------------------------------------------------------------------------
// passes A and B: the states and cotangents at the chunk boundaries
// ---------------------------------------------------------------------------

// Row strides of the bound kernel's tiles: P (k or r) and w at 24 words, Q (v or do) at 8 or dv + 8, so the fragment reads of rows q and
// columns g hit 32 distinct banks.
constexpr int kBoundLdp = kBoundRows + 8;
__host__ __device__ inline int bound_ldq(int dv) { return dv == 8 ? 8 : dv + 8; }
__host__ __device__ inline int bound_stage_floats(int dv) {
  return kChunk * (2 * kBoundLdp + bound_ldq(dv));
}
// two stages and the rows' chunk decays (log2 units)
__host__ __device__ inline int bound_smem_floats(int dv) {
  return 2 * bound_stage_floats(dv) + kBoundRows;
}

// Block (pass and row tile, head, batch): blockIdx.x < row tiles is pass A
// (S, chunks in order, from s0), the rest pass B (G, last chunk first,
// from dS_T). A block holds state rows [nc tile, nc tile + nc), nc =
// min(16, dk), whose channels' logs and decays are its own: no
// block repeats another's. Four warps hold the rows' (16 x dv) state in mma
// accumulator layout, 8-column tiles warp, warp + 4.
__global__ void __launch_bounds__(kBoundThreads) wkv6_bwd_bound_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int dk = p.dk, dv = p.dv, nc = min(kBoundRows, dk), tiles = dk / nc;
  const bool rev = static_cast<int>(blockIdx.x) >= tiles;  // pass B
  const int c0 = (rev ? blockIdx.x - tiles : blockIdx.x) * nc;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  constexpr int ldp = kBoundLdp;
  const int ldq = bound_ldq(dv);
  const int stage_floats = bound_stage_floats(dv);
  float* sLast = smem + 2 * stage_floats;  // [nc]: cum at the chunk's last row
  const bool vec4 = p.vec4 != 0;

  // P = k (A) or r (B), Q = v (A) or do (B, null: zeros)
  const float* pb =
      (rev ? p.r + b * p.r_sb + hh * p.r_sh : p.k + b * p.k_sb + hh * p.k_sh) + c0;
  const long long p_ss = rev ? p.r_ss : p.k_ss;
  const float* wb = p.w + b * p.w_sb + hh * p.w_sh + c0;
  const float* qb = rev ? (p.dout ? p.dout + (static_cast<long long>(b) * p.s_len * p.h + hh) * dv
                                  : nullptr)
                        : p.v + b * p.v_sb + hh * p.v_sh;
  const long long q_ss = rev ? static_cast<long long>(p.h) * dv : p.v_ss;
  if (qb == nullptr) {
    for (int i = tid; i < kChunk * ldq; i += kBoundThreads) {
      smem[2 * kChunk * ldp + i] = 0.f;
      smem[stage_floats + 2 * kChunk * ldp + i] = 0.f;
    }
  }
  auto issue = [&](int n, int stage) {
    const int t0 = n * kChunk, live = min(kChunk, p.s_len - t0);
    float* st = smem + stage * stage_floats;
    stage_rows(st, ldp, pb + t0 * p_ss, p_ss, nc, live, vec4, tid, kBoundThreads);
    stage_rows(st + kChunk * ldp, ldp, wb + t0 * p.w_ss, p.w_ss, nc, live, vec4, tid,
               kBoundThreads);
    if (qb != nullptr)
      stage_rows(st + 2 * kChunk * ldp, ldq, qb + t0 * q_ss, q_ss, dv, live, vec4, tid,
                 kBoundThreads);
    hopper::cp_async_commit();
  };

  // this lane's state: rows c0 + g and c0 + g + 8, columns 8 (warp + 4 m)
  // + 2 q and + 1
  const int n_tiles = dv / 8;
  const bool hi_ok = g + 8 < nc;
  const float* init = rev ? p.dstate : p.s0;
  const long long state_at = (static_cast<long long>(b) * p.h + hh) * dk * dv;
  float x[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int jn = warp + 4 * m;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + g + (e >= 2 ? 8 : 0), j = 8 * jn + 2 * q + (e & 1);
      x[m][e] = jn < n_tiles && (e < 2 || hi_ok) && init != nullptr
                    ? init[state_at + static_cast<long long>(c) * dv + j]
                    : 0.f;
    }
  }

  // cum: thread (c, part) takes rows [part rows, part rows + rows) of
  // channel c; a channel's parts are lanes of one warp
  const int parts = kBoundThreads / nc, rows = kChunk / parts;  // rows <= 4
  const int c = tid / parts, part = tid - c * parts, t_begin = part * rows;
  const int first = rev ? p.nchunk - 1 : 0, dir = rev ? -1 : 1;
  issue(first, 0);
  for (int i = 0; i < p.nchunk; ++i) {
    const int n = first + dir * i, stage = i & 1;
    const int live = min(kChunk, p.s_len - n * kChunk);
    float* sP = smem + stage * stage_floats;
    const float* sW = sP + kChunk * ldp;
    const float* sQ = sW + kChunk * ldp;
    hopper::cp_async_wait_all();
    __syncthreads();  // this chunk's tiles are in; the other stage's readers are done
    if (i + 1 < p.nchunk) issue(n + dir, stage ^ 1);

    // cum and the decays: a thread's rows summed in order, the parts'
    // totals scanned over the channel's lanes; rows past the end take
    // log w = 0. Then P decayed in place: A, k to the chunk's end; B, r
    // back to its start
    float cm[4], acc = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t_begin + r;
      if (r < rows && t < live) acc += fmaxf(log2f(fmaxf(sW[t * ldp + c], kWFloor)), kLog2Floor);
      cm[r] = acc;
    }
    float incl = acc;
    for (int off = 1; off < parts; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off, parts);
      if (part >= off) incl += y;
    }
    const float before = __shfl_up_sync(kFull, incl, 1, parts);
    const float base = part == 0 ? 0.f : before;
    const float last = __shfl_sync(kFull, incl, parts - 1, parts);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r < rows) {
        const float prev = base + (r == 0 ? 0.f : cm[r > 0 ? r - 1 : 0]);
        const float e = rev ? prev : last - (base + cm[r]);
        sP[(t_begin + r) * ldp + c] *= decay2(e);
      }
    }
    if (part == 0) sLast[c] = last;
    __syncthreads();

    // the boundary value out, then X = e^{cum_last} X + P~^T Q
    float* out = (rev ? p.cots : p.states) +
                 ((static_cast<long long>(b) * p.nchunk + n) * p.h + hh) * dk * dv;
    float db[2][4] = {}, ds[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < kChunk / 8; ++kc) {
      const int t = 8 * kc + q;
      hopper::Tf32Split<4> a;
      a.set(0, sP[t * ldp + g]);
      a.set(1, hi_ok ? sP[t * ldp + g + 8] : 0.f);
      a.set(2, sP[(t + 4) * ldp + g]);
      a.set(3, hi_ok ? sP[(t + 4) * ldp + g + 8] : 0.f);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int jn = warp + 4 * m;
        if (jn >= n_tiles) continue;
        hopper::Tf32Split<2> bf;
        bf.set(0, sQ[t * ldq + 8 * jn + g]);
        bf.set(1, sQ[(t + 4) * ldq + 8 * jn + g]);
        hopper::mma_m16n8k8_tf32(ds[m], a.small, bf.big);
        hopper::mma_m16n8k8_tf32(db[m], a.big, bf.big);
        hopper::mma_m16n8k8_tf32(ds[m], a.big, bf.small);
      }
    }
    const float d_lo = decay2(sLast[g]);
    const float d_hi = decay2(hi_ok ? sLast[g + 8] : 0.f);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int jn = warp + 4 * m;
      if (jn >= n_tiles) continue;
      const int j = 8 * jn + 2 * q;
      float* lo = out + static_cast<long long>(c0 + g) * dv + j;
      *reinterpret_cast<float2*>(lo) = make_float2(x[m][0], x[m][1]);
      if (hi_ok) *reinterpret_cast<float2*>(lo + 8 * dv) = make_float2(x[m][2], x[m][3]);
      x[m][0] = fmaf(d_lo, x[m][0], ds[m][0] + db[m][0]);
      x[m][1] = fmaf(d_lo, x[m][1], ds[m][1] + db[m][1]);
      x[m][2] = fmaf(d_hi, x[m][2], ds[m][2] + db[m][2]);
      x[m][3] = fmaf(d_hi, x[m][3], ds[m][3] + db[m][3]);
    }
  }
  if (rev && p.gs0 != nullptr) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int jn = warp + 4 * m;
      if (jn >= n_tiles) continue;
      float* lo = p.gs0 + state_at + static_cast<long long>(c0 + g) * dv + 8 * jn + 2 * q;
      *reinterpret_cast<float2*>(lo) = make_float2(x[m][0], x[m][1]);
      if (hi_ok) *reinterpret_cast<float2*>(lo + 8 * dv) = make_float2(x[m][2], x[m][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass C: every chunk in parallel
// ---------------------------------------------------------------------------

// Threads of a pass C block: one a (row, 8 columns), at least a warp.
__host__ __device__ inline int chunk_threads(int dk, int dv) {
  const int n = dk * (dv / kCols);
  return n < 32 ? 32 : n;
}

// Float offsets in pass C's dynamic shared memory.
struct ChunkSmem {
  int r, k, w, v, d, ck, row, dvp, dov, u, total;
  __host__ __device__ ChunkSmem(int dk, int dv) {
    const int threads = chunk_threads(dk, dv), warps = threads / 32;
    int off = 0;
    r = off; off += kChunk * dk;
    k = off; off += kChunk * dk;
    w = off; off += kChunk * dk;
    v = off; off += kChunk * dv;
    d = off; off += kChunk * dv;
    ck = off; off += (kChunk / kSeg) * threads * kCols;  // [segment][half][thread][4]
    row = off; off += 2 * 3 * kSeg * dk;                 // [buffer][dr, dk, dw][step][row]
    dvp = off; off += 2 * warps * kSeg * dv;             // [buffer][warp][step][column]
    dov = off; off += kChunk;
    u = off; off += dk;
    total = off;
  }
};

// a[0..8) (this lane's row, columns 8 jg + e) summed over the rows of the
// warp: a reduce-scatter over the lane's row bits from the top (bit BIT,
// down to NJ), halving the values held while more than one is left, then
// an all-reduce over the bits left. The lane ends with columns
// 8 jg + off .. + N' (N' = 2 at NJ = 8, else 1).
template <int N, int BIT, int NJ>
__device__ __forceinline__ void rows_reduce(float (&a)[kCols], int lane, int& off) {
  if constexpr (BIT >= NJ && BIT >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool hi = lane & BIT;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = hi ? a[i] : a[i + H];
        const float keep = hi ? a[i + H] : a[i];
        a[i] = keep + __shfl_xor_sync(kFull, send, BIT);
      }
      if (hi) off += H;
      rows_reduce<H, BIT / 2, NJ>(a, lane, off);
    } else {
      a[0] += __shfl_xor_sync(kFull, a[0], BIT);
      rows_reduce<1, BIT / 2, NJ>(a, lane, off);
    }
  }
}
template <int NJ>
__host__ __device__ constexpr int rows_held() {
  return NJ == 8 ? 2 : 1;
}

__device__ __forceinline__ void load8(float (&dst)[kCols], const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

// NJ = dv / 8: the lanes a row (the low lane bits). Block (chunk, head,
// batch); thread tid = NJ c + jg holds row c, columns [8 jg, 8 jg + 8).
template <int NJ>
__global__ void __launch_bounds__(kMaxDim * NJ < 32 ? 32 : kMaxDim * NJ, 1)
    wkv6_bwd_chunk_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  constexpr int dv = NJ * kCols;
  const int dk = p.dk;
  const ChunkSmem lay(dk, dv);
  const int threads = chunk_threads(dk, dv), warps = threads / 32;
  float* sR = smem + lay.r;
  float* sK = smem + lay.k;
  float* sW = smem + lay.w;
  float* sV = smem + lay.v;
  float* sD = smem + lay.d;
  float* sDov = smem + lay.dov;
  float* sU = smem + lay.u;
  const int n = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int t0 = n * kChunk, live = min(kChunk, p.s_len - t0);
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int lane = tid & 31;
  const int c = tid / NJ, jg = tid - c * NJ;
  const bool active = c < dk;
  const int cs = active ? c : 0;  // a row to read for lanes past the last
  const bool vec4 = p.vec4 != 0;

  // the chunk's inputs
  stage_rows(sR, dk, p.r + b * p.r_sb + hh * p.r_sh + t0 * p.r_ss, p.r_ss, dk, live, vec4, tid,
             threads);
  stage_rows(sK, dk, p.k + b * p.k_sb + hh * p.k_sh + t0 * p.k_ss, p.k_ss, dk, live, vec4, tid,
             threads);
  stage_rows(sW, dk, p.w + b * p.w_sb + hh * p.w_sh + t0 * p.w_ss, p.w_ss, dk, live, vec4, tid,
             threads);
  stage_rows(sV, dv, p.v + b * p.v_sb + hh * p.v_sh + t0 * p.v_ss, p.v_ss, dv, live, vec4, tid,
             threads);
  // (b, t, h) rows of the contiguous (b, s, h, d) tensors: (b s + t) h + hh
  const long long row0 = static_cast<long long>(b) * p.s_len * p.h + hh;
  const long long hstride = static_cast<long long>(p.h);
  if (p.dout != nullptr)
    stage_rows(sD, dv, p.dout + (row0 + t0 * hstride) * dv, hstride * dv, dv, live, vec4, tid,
               threads);
  else
    for (int i = tid; i < kChunk * dv; i += threads) sD[i] = 0.f;
  hopper::cp_async_commit();
  for (int i = tid; i < dk; i += threads) sU[i] = p.u[hh * dk + i];

  // this thread's columns of S at the chunk's start and G at its end
  float S[kCols], G[kCols];
  const long long ws_at =
      (((static_cast<long long>(b) * p.nchunk + n) * p.h + hh) * dk + cs) * dv + jg * kCols;
  if (active) {
    load8(S, p.states + ws_at);
    load8(G, p.cots + ws_at);
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) S[e] = G[e] = 0.f;
  }
  hopper::cp_async_wait_all();
  __syncthreads();

  // do_t . v_t a step: warp w takes steps w, w + warps, ...
  for (int t = warp; t < kChunk; t += warps) {
    float a = 0.f;
    for (int j = lane; j < dv; j += 32) a = fmaf(sD[t * dv + j], sV[t * dv + j], a);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) a += __shfl_xor_sync(kFull, a, o);
    if (lane == 0) sDov[t] = a;
  }
  __syncthreads();

  const float uc = active ? sU[c] : 0.f;
  // this thread's checkpoint floats: segment sg's, as two float4 a thread
  // [sg][half][thread][4], so a warp's stores are 512 contiguous bytes
  float* ck = smem + lay.ck + tid * 4;
  const int ck_half = threads * 4, ck_seg = 2 * ck_half;
  auto save = [&](int sg) {
    float* at = ck + sg * ck_seg;
    *reinterpret_cast<float4*>(at) = make_float4(S[0], S[1], S[2], S[3]);
    *reinterpret_cast<float4*>(at + ck_half) = make_float4(S[4], S[5], S[6], S[7]);
  };
  // an input of this thread's row at step t (0 past the last row)
  auto row_in = [&](const float* base, int t) { return active ? base[t * dk + c] : 0.f; };

  // ---- the checkpoint walk: S at every segment's start ----
  const int nseg = (live + kSeg - 1) / kSeg;
  for (int sg = 0; sg + 1 < nseg; ++sg) {
    save(sg);
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const int t = sg * kSeg + i;
      const float kt = row_in(sK, t), wt = row_in(sW, t);
      float vv[kCols];
      load8(vv, sV + t * dv + jg * kCols);
#pragma unroll
      for (int e = 0; e < kCols; ++e) S[e] = fmaf(wt, S[e], kt * vv[e]);
    }
  }
  save(nseg - 1);

  // ---- the segments last to first ----
  // One segment: S_{t-1} of its steps recomputed from its checkpoint (dr,
  // and this row's part of du), then G walks back through them (dk, dw,
  // dv). Each walk keeps its results in registers and stores them after its
  // last step, so no shared-memory store sits between one step's loads and
  // the next's; a full segment (FULL) has no branch between its steps.
  constexpr int held = rows_held<NJ>();
  float du = 0.f;
  auto segment = [&](auto full, int sg, int cnt, float* sRow, float* sDvp) {
    constexpr bool FULL = decltype(full)::value;
    const int ta = sg * kSeg;
    {
      const float* at = ck + sg * ck_seg;
      const float4 lo = *reinterpret_cast<const float4*>(at);
      const float4 hi = *reinterpret_cast<const float4*>(at + ck_half);
      S[0] = lo.x; S[1] = lo.y; S[2] = lo.z; S[3] = lo.w;
      S[4] = hi.x; S[5] = hi.y; S[6] = hi.z; S[7] = hi.w;
    }
    float hist[kSeg][kCols], dr_out[kSeg];
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      if (FULL || i < cnt) {
        const int t = ta + i;
        const float rt = row_in(sR, t), kt = row_in(sK, t), wt = row_in(sW, t);
        const float dov = sDov[t];
        float vv[kCols], dd[kCols];
        load8(vv, sV + t * dv + jg * kCols);
        load8(dd, sD + t * dv + jg * kCols);
        float dr = 0.f;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          hist[i][e] = S[e];
          dr = fmaf(dd[e], S[e], dr);
          S[e] = fmaf(wt, S[e], kt * vv[e]);
        }
#pragma unroll
        for (int o = NJ / 2; o >= 1; o >>= 1) dr += __shfl_xor_sync(kFull, dr, o);
        dr_out[i] = fmaf(uc * kt, dov, dr);
        du = fmaf(rt * kt, dov, du);
      }
    }
    // dk or dw a lane (NJ > 1: the lower half of a row's lanes dk, the
    // upper dw), both with one lane a row
    float dkw_out[kSeg][NJ > 1 ? 1 : 2], dv_out[kSeg][held];
    int dv_off = 0;
#pragma unroll
    for (int i = kSeg - 1; i >= 0; --i) {
      if (FULL || i < cnt) {
        const int t = ta + i;
        const float rt = row_in(sR, t), kt = row_in(sK, t), wt = row_in(sW, t);
        const float ru = rt * uc;
        float vv[kCols], dd[kCols];
        load8(vv, sV + t * dv + jg * kCols);
        load8(dd, sD + t * dv + jg * kCols);
        float dkp = 0.f, dwp = 0.f, dvp[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const float xe = fmaf(ru, dd[e], G[e]);
          dkp = fmaf(xe, vv[e], dkp);
          dwp = fmaf(G[e], hist[i][e], dwp);
          dvp[e] = kt * xe;
          G[e] = fmaf(wt, G[e], rt * dd[e]);
        }
        // dk and dw over the row's lanes: the lower half keeps dk, the upper dw
        if constexpr (NJ > 1) {
          const bool up = jg & (NJ / 2);
          float x = (up ? dwp : dkp) + __shfl_xor_sync(kFull, up ? dkp : dwp, NJ / 2);
#pragma unroll
          for (int o = NJ / 4; o >= 1; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
          dkw_out[i][0] = x;
        } else {
          dkw_out[i][0] = dkp;
          dkw_out[i][NJ > 1 ? 0 : 1] = dwp;
        }
        // dv over the warp's rows
        dv_off = 0;
        rows_reduce<kCols, 16, NJ>(dvp, lane, dv_off);
#pragma unroll
        for (int e = 0; e < held; ++e) dv_out[i][e] = dvp[e];
      }
    }
    // the walks' results into the segment's buffers
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      if (FULL || i < cnt) {
        if (active && jg == 0) sRow[i * dk + c] = dr_out[i];
        if constexpr (NJ > 1) {
          if (active && (jg & (NJ / 2 - 1)) == 0)
            sRow[((jg & (NJ / 2) ? 2 : 1) * kSeg + i) * dk + c] = dkw_out[i][0];
        } else if (active) {
          sRow[(kSeg + i) * dk + c] = dkw_out[i][0];
          sRow[(2 * kSeg + i) * dk + c] = dkw_out[i][NJ > 1 ? 0 : 1];
        }
        float* to = sDvp + (warp * kSeg + i) * dv + jg * kCols + dv_off;
#pragma unroll
        for (int e = 0; e < held; ++e) to[e] = dv_out[i][e];
      }
    }
  };

  const long long out_row = row0 + static_cast<long long>(t0) * p.h;
  for (int sg = nseg - 1; sg >= 0; --sg) {
    const int ta = sg * kSeg, cnt = min(kSeg, live - ta);
    float* sRow = smem + lay.row + (sg & 1) * 3 * kSeg * dk;  // [dr, dk, dw][step][row]
    float* sDvp = smem + lay.dvp + (sg & 1) * warps * kSeg * dv;  // [warp][step][column]
    if (cnt == kSeg)
      segment(std::true_type{}, sg, cnt, sRow, sDvp);
    else
      segment(std::false_type{}, sg, cnt, sRow, sDvp);
    __syncthreads();  // the segment's rows and dv parts are in
    // the segment's outputs: the first half of the threads dv (the warps'
    // parts in warp order), the second dr, dk, dw
    const int half = threads / 2;
    if (tid < half) {
      for (int idx = tid; idx < cnt * dv; idx += half) {
        const int i = idx / dv, j = idx - i * dv;
        const float* part = sDvp + i * dv + j;
        float acc = part[0];
#pragma unroll 4
        for (int wi = 1; wi < warps; ++wi) acc += part[wi * kSeg * dv];
        p.gv[(out_row + static_cast<long long>(ta + i) * p.h) * dv + j] = acc;
      }
    } else {
      const int dk_shift = __ffs(dk) - 1;
      for (int idx = tid - half; idx < cnt * dk; idx += half) {
        const int i = idx >> dk_shift, cc = idx & (dk - 1);
        const long long at = (out_row + static_cast<long long>(ta + i) * p.h) * dk + cc;
        p.gr[at] = sRow[i * dk + cc];
        p.gk[at] = sRow[(kSeg + i) * dk + cc];
        p.gw[at] = sRow[(2 * kSeg + i) * dk + cc];
      }
    }
    // the next segment writes the other buffer; the one after this one
    // waits for the barrier above it, after these reads
  }
  // du: this chunk's part of each row, its segments last to first, a
  // segment's steps in order
  if (active && jg == 0)
    p.gu_part[((static_cast<long long>(b) * p.nchunk + n) * p.h + hh) * dk + c] = du;
}

// du: the (batch, chunk) parts summed in that order.
__global__ void __launch_bounds__(kSumThreads) wkv6_bwd_du_kernel(const float* part, float* gu,
                                                                 int parts, int hdk) {
  for (int e = blockIdx.x * kSumThreads + threadIdx.x; e < hdk; e += gridDim.x * kSumThreads) {
    float acc = 0.f;
    for (int i = 0; i < parts; ++i) acc += part[static_cast<long long>(i) * hdk + e];
    gu[e] = acc;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using Kernel = void (*)(const Params);

const Kernel kChunkKernels[4] = {wkv6_bwd_chunk_kernel<1>, wkv6_bwd_chunk_kernel<2>,
                                 wkv6_bwd_chunk_kernel<4>, wkv6_bwd_chunk_kernel<8>};

int nj_index(int dv) { return dv == 8 ? 0 : dv == 16 ? 1 : dv == 32 ? 2 : 3; }

// cudaFuncSetAttribute for the kernels' largest dynamic shared memory,
// once per device (a bit of `done` each).
std::atomic<uint64_t> g_smem_done{0};

cudaError_t set_smem_once(int device) {
  const uint64_t bit = 1ull << (device & 63);
  if (g_smem_done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_bound_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bound_smem_floats(kMaxDim) * static_cast<int>(sizeof(float)));
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    const int bytes = ChunkSmem(kMaxDim, kCols << i).total * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(kChunkKernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  }
  if (err != cudaSuccess) return err;
  g_smem_done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

bool head_size_ok(int d) { return d == 8 || d == 16 || d == 32 || d == 64; }

long long chunks(int s) { return (s + kChunk - 1) / kChunk; }

bool aligned16(const void* ptr, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 && ss % 4 == 0 &&
         sh % 4 == 0;
}

}  // namespace

// Floats of scratch wkv6_bwd needs for these shapes: the states and the
// cotangents at the chunk boundaries, and du's (batch, chunk) parts.
extern "C" long long wkv6_bwd_workspace(int b, int s, int h, int dk, int dv) {
  const long long n = static_cast<long long>(b) * chunks(s) * h * dk;
  return 2 * n * dv + n;
}

// Blocks resident an SM of each kernel at these head sizes, as the
// occupancy calculator gives them: out[0] passes A and B, out[1] pass C,
// out[2] du's sum; out[3] pass C's threads a block. Returns a cudaError_t.
extern "C" int wkv6_bwd_occupancy(int dk, int dv, int device, int* out) {
  if (!head_size_ok(dk) || !head_size_ok(dv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = set_smem_once(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], wkv6_bwd_bound_kernel, kBoundThreads,
        bound_smem_floats(dv) * sizeof(float));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], kChunkKernels[nj_index(dv)], chunk_threads(dk, dv),
        ChunkSmem(dk, dv).total * sizeof(float));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], wkv6_bwd_du_kernel,
                                                        kSumThreads, 0);
  out[3] = chunk_threads(dk, dv);
  return static_cast<int>(err);
}

// Gradients of (o, final state) of the WKV6 forward with respect to r, k,
// v, w, u and s0 (when ds0 is not null). r/k/v/w strides are (batch, seq,
// head) in elements with the last dim contiguous; everything else is
// contiguous (see the header); dout, dstate, s0 and ds0 may be null. All
// fp32; dk, dv in {8, 16, 32, 64}; `workspace` holds
// wkv6_bwd_workspace(...) floats. Three launches on `stream`. Returns a
// cudaError_t (0 = ok).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, const void* dout, const void* dstate,
                        void* gr, void* gk, void* gv, void* gw, void* gu, void* gs0,
                        void* workspace, int b, int s, int h, int dk, int dv,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || h <= 0 || s <= 0) return static_cast<int>(cudaSuccess);
  if (!head_size_ok(dk) || !head_size_ok(dv)) return static_cast<int>(cudaErrorInvalidValue);
  err = set_smem_once(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunk = static_cast<int>(chunks(s));
  const long long n = static_cast<long long>(b) * nchunk * h * dk;
  float* ws = static_cast<float*>(workspace);
  const int vec4 = aligned16(r, r_sb, r_ss, r_sh) && aligned16(k, k_sb, k_ss, k_sh) &&
                   aligned16(v, v_sb, v_ss, v_sh) && aligned16(w, w_sb, w_ss, w_sh) &&
                   reinterpret_cast<uintptr_t>(dout) % 16 == 0;
  const Params p{static_cast<const float*>(r), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(w),
                 static_cast<const float*>(u), static_cast<const float*>(s0),
                 static_cast<const float*>(dout), static_cast<const float*>(dstate),
                 static_cast<float*>(gr), static_cast<float*>(gk), static_cast<float*>(gv),
                 static_cast<float*>(gw), static_cast<float*>(gs0),
                 ws, ws + n * dv, ws + 2 * n * dv,
                 s, h, dk, dv, nchunk, vec4,
                 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = dk < kBoundRows ? 1 : dk / kBoundRows;
  wkv6_bwd_bound_kernel<<<dim3(2 * row_tiles, h, b), kBoundThreads,
                          bound_smem_floats(dv) * sizeof(float), st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kChunkKernels[nj_index(dv)]<<<dim3(nchunk, h, b), chunk_threads(dk, dv),
                                ChunkSmem(dk, dv).total * sizeof(float), st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hdk = h * dk;
  const int blocks = (hdk + kSumThreads - 1) / kSumThreads;
  wkv6_bwd_du_kernel<<<blocks, kSumThreads, 0, st>>>(p.gu_part, static_cast<float*>(gu),
                                                     b * nchunk, hdk);
  return static_cast<int>(cudaGetLastError());
}
