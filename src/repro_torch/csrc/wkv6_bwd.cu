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
// Every state element follows its own scalar recurrence in each
// direction: S[c,j] by w_t[c], k_t[c] v_t[j]; G[c,j] by w_t[c], r_t[c]
// do_t[j]. The kernel evaluates no exponential and no logarithm and
// divides by nothing: a decay that underflowed to 0, or one below K4's
// e^-60 floor, gives finite gradients (dw from the product above, not
// from d log w / w), and w enters as given, as in autograd of the plain
// version (kernels/rwkv_scan/ref.py::wkv6_ref).
//
// States. dw and dr need S_{t-1} where the reverse sweep has G_t. S is
// never recovered backwards as (S_t - k_t^T v_t) / w_t (that division
// blows up for fast decays). A forward sweep writes the state at the start
// of every segment of 16 steps to a scratch in device memory; the reverse
// sweep takes the segments last to first, recomputes a segment's 16 states
// from its checkpoint into shared memory, and walks the segment backwards.
//
// Design (a simple kernel: right first, fast later). One block of dk
// threads per (column tile of 16 state columns, head, batch); thread c
// holds row c of its tile of S and of G in registers. Per segment, the
// block stages r, k, w (dk a step) and v, do (the tile's columns) in
// shared memory. dr, dk and dw are sums over j: thread c sums its tile's
// 16 columns; with several tiles a head each tile writes a partial row,
// and a second kernel sums the tiles in tile order. dv sums over the dk
// rows: in the reverse sweep each thread overwrites its recomputed state
// in shared memory with k_t[c] (G_t[c,j] + r_t[c] u[c] do_t[j]), and after
// the segment the block sums the rows in row order. du: each block sums
// its tile's part over time; the second kernel sums the (batch, tile)
// partials in that order. No atomics: a call repeats bit for bit.
//
// Bound on the H100: operations. A token and head take six multiply-adds
// a state element (S recomputed, G, dr, dk, dv, dw): 12 dk dv operations,
// against 4 (6 dk + 3 dv) bytes read and written once (r, k, w, v, do in;
// dr, dk, dw, dv out). At dk = dv = 64 that is 21 operations a byte, just
// above the fp32 line (67e12 / 3.35e12 = 20); chip_smoke.py times it
// against that bound.
//
// Layout: r, k, w (b, s, h, dk) and v (b, s, h, dv) as K4 reads them,
// through their batch/sequence/head strides with the last dimension
// contiguous; do (b, s, h, dv), dS_T and s0 (b, h, dk, dv), u (h, dk)
// contiguous. dr, dk, dw (b, s, h, dk), dv (b, s, h, dv), du (h, dk) and
// ds0 (b, h, dk, dv) are written contiguous. do, dS_T, s0 and ds0 may be
// null (a zero cotangent, a zero initial state, no ds0).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kSeg = 16;     // steps a segment: a checkpoint of S at each start
constexpr int kTile = 16;    // state columns a block (dv if smaller)
constexpr int kMaxDim = 64;  // threads a block: one a key channel
constexpr int kSumThreads = 256;

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;      // or null
  const float* dout;    // or null
  const float* dstate;  // or null
  float* gr;  // dr, dk, dw: the outputs (one tile a head) or the tile
  float* gk;  // partials, (tiles, b, s, h, dk) each
  float* gw;
  float* gv;
  float* gu_part;  // du's partials, (b, tiles, h, dk)
  float* gs0;      // ds0, or null
  float* ckpt;     // (b, h, tiles, segments, dk, tile)
  int s_len, h, dk, dv, tiles, nseg;
  long long r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh;
};

// Floats of dynamic shared memory: the segment's states (or dv terms),
// rows padded to an odd stride, then r, k, w and v, do.
__host__ __device__ inline int smem_floats(int dk, int tj) {
  return kSeg * dk * (tj + 1) + 3 * kSeg * dk + 2 * kSeg * tj;
}

template <int TJ>
__global__ void __launch_bounds__(kMaxDim) wkv6_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int LD = TJ + 1;  // odd: row c of thread c lands on its own bank
  const int dk = p.dk, c = threadIdx.x;
  const int tile = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int j0 = tile * TJ;
  float* hist = smem;                // [kSeg][dk][LD]
  float* sR = hist + kSeg * dk * LD;  // [kSeg][dk]
  float* sK = sR + kSeg * dk;
  float* sW = sK + kSeg * dk;
  float* sV = sW + kSeg * dk;  // [kSeg][TJ]
  float* sD = sV + kSeg * TJ;  // [kSeg][TJ]

  const float* rb = p.r + b * p.r_sb + hh * p.r_sh;
  const float* kb = p.k + b * p.k_sb + hh * p.k_sh;
  const float* wb = p.w + b * p.w_sb + hh * p.w_sh;
  const float* vb = p.v + b * p.v_sb + hh * p.v_sh + j0;
  // (b, t, h) rows of the contiguous (b, s, h, d) tensors: (b s + t) h + hh
  const long long row0 = static_cast<long long>(b) * p.s_len * p.h + hh;
  const long long n = static_cast<long long>(gridDim.z) * p.s_len * p.h * dk;
  const long long part = p.tiles > 1 ? tile * n : 0;
  float* dr_out = p.gr + part;
  float* dk_out = p.gk + part;
  float* dw_out = p.gw + part;
  const long long state_at = ((static_cast<long long>(b) * p.h + hh) * dk + c) * p.dv + j0;
  float* ck = p.ckpt +
              (((static_cast<long long>(b) * p.h + hh) * p.tiles + tile) * p.nseg * dk + c) * TJ;
  const float uc = p.u[hh * dk + c];

  // a segment's inputs: rows past the end are zeros (never read)
  auto stage = [&](int t0, int live) {
    for (int t = 0; t < kSeg; ++t) {
      const bool on = t < live;
      const long long ts = t0 + t;
      sR[t * dk + c] = on ? rb[ts * p.r_ss + c] : 0.f;
      sK[t * dk + c] = on ? kb[ts * p.k_ss + c] : 0.f;
      sW[t * dk + c] = on ? wb[ts * p.w_ss + c] : 0.f;
    }
    for (int idx = c; idx < kSeg * TJ; idx += dk) {
      const int t = idx / TJ, j = idx - t * TJ;
      const bool on = t < live;
      sV[idx] = on ? vb[(t0 + t) * p.v_ss + j] : 0.f;
      sD[idx] = on && p.dout ? p.dout[(row0 + static_cast<long long>(t0 + t) * p.h) * p.dv +
                                      j0 + j]
                             : 0.f;
    }
  };

  // ---- forward sweep: checkpoints, dr, du ----
  float st[TJ];
#pragma unroll
  for (int j = 0; j < TJ; ++j) st[j] = p.s0 ? p.s0[state_at + j] : 0.f;
  float du = 0.f;
  for (int seg = 0; seg < p.nseg; ++seg) {
    const int t0 = seg * kSeg, live = min(kSeg, p.s_len - t0);
    __syncthreads();  // the last segment's readers are done with the stage
    stage(t0, live);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TJ; ++j) ck[seg * dk * TJ + j] = st[j];
    for (int t = 0; t < live; ++t) {
      const float rt = sR[t * dk + c], kt = sK[t * dk + c], wt = sW[t * dk + c];
      float dov = 0.f, dr = 0.f;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const float vj = sV[t * TJ + j], dj = sD[t * TJ + j];
        dov = fmaf(dj, vj, dov);
        dr = fmaf(dj, st[j], dr);
        st[j] = fmaf(wt, st[j], kt * vj);
      }
      dr = fmaf(uc * kt, dov, dr);
      du = fmaf(rt * kt, dov, du);
      dr_out[(row0 + static_cast<long long>(t0 + t) * p.h) * dk + c] = dr;
    }
  }

  // ---- reverse sweep, a segment at a time: dk, dw, dv, then ds0 ----
  float g[TJ];
#pragma unroll
  for (int j = 0; j < TJ; ++j) g[j] = p.dstate ? p.dstate[state_at + j] : 0.f;
  for (int seg = p.nseg - 1; seg >= 0; --seg) {
    const int t0 = seg * kSeg, live = min(kSeg, p.s_len - t0);
    __syncthreads();  // the last segment's dv sums are done with hist
    stage(t0, live);
    // this thread's own checkpoint: S_{t0-1}
#pragma unroll
    for (int j = 0; j < TJ; ++j) st[j] = ck[seg * dk * TJ + j];
    __syncthreads();
    for (int t = 0; t < live; ++t) {  // S_{t-1} of each step, into hist
      float* row = hist + (t * dk + c) * LD;
      const float kt = sK[t * dk + c], wt = sW[t * dk + c];
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        row[j] = st[j];
        st[j] = fmaf(wt, st[j], kt * sV[t * TJ + j]);
      }
    }
    for (int t = live - 1; t >= 0; --t) {  // g holds G_t
      float* row = hist + (t * dk + c) * LD;
      const float rt = sR[t * dk + c], kt = sK[t * dk + c], wt = sW[t * dk + c];
      const float ru = rt * uc;
      float dkc = 0.f, dwc = 0.f;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const float dj = sD[t * TJ + j];
        const float x = fmaf(ru, dj, g[j]);
        dkc = fmaf(x, sV[t * TJ + j], dkc);
        dwc = fmaf(g[j], row[j], dwc);
        row[j] = kt * x;  // dv's term, in place of S_{t-1}
        g[j] = fmaf(wt, g[j], rt * dj);
      }
      const long long at = (row0 + static_cast<long long>(t0 + t) * p.h) * dk + c;
      dk_out[at] = dkc;
      dw_out[at] = dwc;
    }
    __syncthreads();
    // dv: each (step, column) sums its dk rows in row order
    for (int idx = c; idx < live * TJ; idx += dk) {
      const int t = idx / TJ, j = idx - t * TJ;
      const float* col = hist + t * dk * LD + j;
      float acc = 0.f;
      for (int cc = 0; cc < dk; ++cc) acc += col[cc * LD];
      p.gv[(row0 + static_cast<long long>(t0 + t) * p.h) * p.dv + j0 + j] = acc;
    }
  }
  if (p.gs0) {
#pragma unroll
    for (int j = 0; j < TJ; ++j) p.gs0[state_at + j] = g[j];
  }
  p.gu_part[((static_cast<long long>(b) * p.tiles + tile) * p.h + hh) * dk + c] = du;
}

struct SumParams {
  const float* part;     // (3, tiles, n): dr, dk, dw partials
  const float* gu_part;  // (bt, hdk)
  float* gr;
  float* gk;
  float* gw;
  float* gu;
  long long n;  // b s h dk
  int tiles, bt, hdk;
};

// The tiles' partial rows of dr, dk and dw summed in tile order (where a
// head has several tiles), and du's (batch, tile) partials in that order.
__global__ void __launch_bounds__(kSumThreads) wkv6_bwd_sum_kernel(const SumParams q) {
  const long long rows = q.tiles > 1 ? 3 * q.n : 0;
  const long long total = rows + q.hdk;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += stride) {
    if (i < rows) {
      const int which = static_cast<int>(i / q.n);
      const long long e = i - which * q.n;
      const float* src = q.part + static_cast<long long>(which) * q.tiles * q.n + e;
      float acc = src[0];
      for (int t = 1; t < q.tiles; ++t) acc += src[t * q.n];
      (which == 0 ? q.gr : which == 1 ? q.gk : q.gw)[e] = acc;
    } else {
      const int e = static_cast<int>(i - rows);
      float acc = 0.f;
      for (int bt = 0; bt < q.bt; ++bt) acc += q.gu_part[static_cast<long long>(bt) * q.hdk + e];
      q.gu[e] = acc;
    }
  }
}

using Kernel = void (*)(const Params);

// cudaFuncSetAttribute for the largest dynamic shared memory, once per
// device (a bit of `done` each).
std::atomic<uint64_t> g_smem_done{0};

cudaError_t set_smem_once(int device) {
  const uint64_t bit = 1ull << (device & 63);
  if (g_smem_done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const Kernel kernels[] = {wkv6_bwd_kernel<8>, wkv6_bwd_kernel<16>};
  const int tiles[] = {8, 16};
  for (int i = 0; i < 2; ++i) {
    const int bytes = smem_floats(kMaxDim, tiles[i]) * static_cast<int>(sizeof(float));
    const cudaError_t err =
        cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  g_smem_done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

bool head_size_ok(int d) { return d == 8 || d == 16 || d == 32 || d == 64; }

int tile_of(int dv) { return dv < kTile ? dv : kTile; }

long long segments(int s) { return (s + kSeg - 1) / kSeg; }

}  // namespace

// Floats of scratch wkv6_bwd needs for these shapes: the checkpoints,
// the tile partials of dr, dk, dw (several tiles a head only) and du's.
extern "C" long long wkv6_bwd_workspace(int b, int s, int h, int dk, int dv) {
  const long long tiles = dv / tile_of(dv);
  const long long n = static_cast<long long>(b) * s * h * dk;
  return static_cast<long long>(b) * h * segments(s) * dk * dv + (tiles > 1 ? 3 * tiles * n : 0) +
         static_cast<long long>(b) * tiles * h * dk;
}

// Gradients of (o, final state) of the WKV6 forward with respect to r, k,
// v, w, u and s0 (when ds0 is not null). r/k/v/w strides are (batch, seq,
// head) in elements with the last dim contiguous; everything else is
// contiguous (see the header); dout, dstate, s0 and ds0 may be null. All
// fp32; dk, dv in {8, 16, 32, 64}; `workspace` holds
// wkv6_bwd_workspace(...) floats. Two launches on `stream`. Returns a
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
  const int tj = tile_of(dv), tiles = dv / tj, nseg = static_cast<int>(segments(s));
  const long long n = static_cast<long long>(b) * s * h * dk;
  float* ws = static_cast<float*>(workspace);
  float* ckpt = ws;
  float* part = ckpt + static_cast<long long>(b) * h * nseg * dk * dv;
  float* gu_part = part + (tiles > 1 ? 3 * tiles * n : 0);
  const bool split = tiles > 1;
  const Params p{static_cast<const float*>(r), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(w),
                 static_cast<const float*>(u), static_cast<const float*>(s0),
                 static_cast<const float*>(dout), static_cast<const float*>(dstate),
                 split ? part : static_cast<float*>(gr),
                 split ? part + tiles * n : static_cast<float*>(gk),
                 split ? part + 2 * tiles * n : static_cast<float*>(gw),
                 static_cast<float*>(gv), gu_part, static_cast<float*>(gs0), ckpt,
                 s, h, dk, dv, tiles, nseg,
                 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_floats(dk, tj) * sizeof(float);
  const dim3 grid(tiles, h, b);
  if (tj == 16)
    wkv6_bwd_kernel<16><<<grid, dk, smem, st>>>(p);
  else
    wkv6_bwd_kernel<8><<<grid, dk, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const SumParams q{part, gu_part, static_cast<float*>(gr), static_cast<float*>(gk),
                    static_cast<float*>(gw), static_cast<float*>(gu), n, tiles, b * tiles,
                    h * dk};
  const long long total = (split ? 3 * n : 0) + static_cast<long long>(h) * dk;
  const long long want = (total + kSumThreads - 1) / kSumThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  wkv6_bwd_sum_kernel<<<blocks, kSumThreads, 0, st>>>(q);
  return static_cast<int>(cudaGetLastError());
}
