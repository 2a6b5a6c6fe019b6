// Fused softmax cross-entropy, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/xent/xent.py::xent_forward
// (body _xent_kernel) and the backward of src/repro/kernels/xent/ops.py::
// _bwd (a lax.scan over vocab chunks in the JAX package). For hidden states
// h (T, d), the unembedding W in the port's (V, d) row layout and targets
// y (T,):
//   forward:  loss[t] = logsumexp_v(h_t . W_v) - h_t . W_{y_t}, and logz[t];
//   backward: p[t, v] = (exp(h_t . W_v - logz[t]) - 1[v = y_t]) * g[t],
//             dh = p W (T, d), dW = p^T h (V, d).
// The one-hot part is kept out of the long vocab sum of dh: dh = e W -
// g[t] W_{y_t} with e = exp(.) g, subtracted once at the end, so the fp32
// partial sums stay at the size of the softmax terms (with it inside, a
// long chain carries |W_y| and rounds at that scale).
// No (T, V) tensor is ever written: the forward keeps per-row running
// statistics, the backward recomputes the logits one vocab chunk at a time
// into a (T, chunk) scratch that stays in the 50 MB L2.
//
// What bounds it on this card: at the training path's shapes (T = b x G =
// 1,024 rows, d = 896, V = 151,936, bf16) the forward is 2 T V d = 279
// GFLOP and the backward three such products, 836 GFLOP; W is 272 MB. At
// the tensor cores' 989 TFLOP/s that is 0.28 and 0.85 ms, against 0.08 ms
// to read W once: operations bound both.
//
// Two routes, chosen by dtype:
//  - bf16 (the training path): the products run on the tensor cores (wgmma,
//    bf16 operands from 128-byte-swizzled shared memory, fp32 accumulators
//    in registers), fed by TMA into a ring of stages paced by mbarriers: one
//    producer warp, two consumer warpgroups of 64 rows each
//    (../../common/csrc/hopper.cuh; the logit-tile mainloop, shared with
//    select.cu, in ../../common/csrc/tc_mainloop.cuh).
//    forward (xent_partial_tc): block = (128-row tile, vocab chunk), row
//    tile fastest so the blocks reading one W chunk run together; each walks
//    its chunk's 128-row vocab tiles, folds every logit tile into per-row
//    running (max, sum-exp) in registers (a row's columns live in the 4
//    lanes of a quad) and picks up the target logit; xent_merge_kernel
//    merges the chunks in vocab order. The logits are summed stage by stage
//    in fp32 (logit_tile), not in the tensor cores' truncating accumulator.
//    backward, per vocab chunk of C rows: the logits again, with the
//    forward's mainloop, into e = exp(lo - logz) g stored as a bf16 pair,
//    e_hi = bf16(e), e_lo = bf16(e - e_hi) (what is left is about 2^-18 |e|;
//    one bf16 would lose the dh that cancels against g W_y when the softmax
//    is sharp); then both products of the chunk from the pair, each two
//    wgmma passes into one fp32 accumulator: dh tiles (e_hi + e_lo) W_c,
//    read-added-written in fp32 by their owning block, chunks in stream
//    order, and dW tiles (e_hi + e_lo)^T h minus g h_t on row y_t, written in
//    W's dtype. One launch per chunk (xent_grad_tc) holds chunk c's dh and
//    dW tiles and chunk c + 1's probabilities, over a double-buffered
//    scratch (8 T C bytes, C chosen so one chunk's pair is within 16 MB of
//    L2); xent_probs_tc makes the first chunk's. No atomics: two runs give
//    bit-identical gradients.
//  - fp32: the products run on CUDA cores in fp32 (64 x 64 x 32 shared-
//    memory tiles, 4 x 4 outputs per thread, select.cu's scheme): fp32 on the
//    tensor cores would be TF32, three decimal digits. The backward there is
//    probs / dh / dW launches per chunk through a (T, C) fp32 scratch.
// Both routes accumulate in fp32 and mask the ragged vocab edge themselves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"
#include "../../common/csrc/tc_mainloop.cuh"

namespace {

constexpr int kBM = 64;   // output rows per block
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 32;   // depth per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

struct Smem {
  float a[kBK][kBM + 4];  // A tile, k-major
  float b[kBK][kBN + 4];  // B tile, k-major
};

// The 16 x 16 threads' 4 x 4 outputs of the product of smem stage k.
__device__ __forceinline__ void mma_stage(const Smem& s, int tx, int ty,
                                          float acc[4][4]) {
#pragma unroll 8
  for (int k = 0; k < kBK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] = sum_k h[r0 + ty*4 + i, k] * w[c0 + tx*4 + j, k] over the full
// depth d, both operands row-major with d contiguous (d % 8 == 0, 16-byte
// aligned rows): the logit tile of rows [r0, r0 + 64) and vocab rows
// [c0, c0 + 64). Out-of-range rows read as 0.
template <typename T>
__device__ __forceinline__ void logit_tile(const T* __restrict__ h,
                                           const T* __restrict__ w,
                                           int n_rows, int n_cols, int d,
                                           int r0, int c0, Smem& s,
                                           float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ld_row = tid / 4;        // loader: 8 consecutive depth values
  const int ld_k = (tid % 4) * 8;    // of one row
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    float xa[8], xb[8];
    const bool k_ok = k0 + ld_k < d;   // d % 8 == 0: all 8 or none
    const int ra = r0 + ld_row, cb = c0 + ld_row;
    if (k_ok && ra < n_rows) load8(h + (long long)ra * d + k0 + ld_k, xa);
    else for (int e = 0; e < 8; ++e) xa[e] = 0.f;
    if (k_ok && cb < n_cols) load8(w + (long long)cb * d + k0 + ld_k, xb);
    else for (int e = 0; e < 8; ++e) xb[e] = 0.f;
    __syncthreads();  // the previous stage is consumed
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s.a[ld_k + e][ld_row] = xa[e];
      s.b[ld_k + e][ld_row] = xb[e];
    }
    __syncthreads();
    mma_stage(s, tx, ty, acc);
  }
}

// acc[i][j] = sum_k A(m0 + ty*4 + i, k) * B(k, n0 + tx*4 + j), k < K, with
// A(m, k) = A[m * sam + k * sak] and B(k, n) = B[k * sbk + n * sbn].
// A_KC: A is contiguous along k (else along m); B_NC: B is contiguous along
// n. The loader walks the contiguous axis with neighbouring threads.
// ONE_HOT (A(m, k) = e[k, m] of vocab row v0 + m and token row k): A is
// read as e - 1[v0 + m = y_k] g_k.
template <typename TA, typename TB, bool A_KC, bool B_NC,
          bool ONE_HOT = false>
__device__ __forceinline__ void strided_tile(
    const TA* __restrict__ A, long long sam, long long sak,
    const TB* __restrict__ B, long long sbk, long long sbn, int M, int N,
    int K, int m0, int n0, Smem& s, float acc[4][4],
    const int* __restrict__ y = nullptr, const float* __restrict__ g = nullptr,
    int v0 = 0) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    float xa[8], xb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int m = A_KC ? tid / 4 : (tid % 8) * 8 + e;
      const int k = A_KC ? (tid % 4) * 8 + e : tid / 8;
      const int gm = m0 + m, gk = k0 + k;
      xa[e] = (gm < M && gk < K) ? to_f(A[gm * sam + gk * sak]) : 0.f;
      if (ONE_HOT && gm < M && gk < K && v0 + gm == y[gk]) xa[e] -= g[gk];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = B_NC ? (tid % 8) * 8 + e : tid / 4;
      const int k = B_NC ? tid / 8 : (tid % 4) * 8 + e;
      const int gn = n0 + n, gk = k0 + k;
      xb[e] = (gn < N && gk < K) ? to_f(B[gk * sbk + gn * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (A_KC) s.a[(tid % 4) * 8 + e][tid / 4] = xa[e];
      else s.a[tid / 8][(tid % 8) * 8 + e] = xa[e];
      if (B_NC) s.b[tid / 8][(tid % 8) * 8 + e] = xb[e];
      else s.b[(tid % 4) * 8 + e][tid / 4] = xb[e];
    }
    __syncthreads();
    mma_stage(s, tx, ty, acc);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// grid: (ceil(T / kBM), n_chunks); chunk c covers vocab tiles
// [c * per_chunk, (c + 1) * per_chunk). Writes per (chunk, row) the running
// max, sum-exp and the target logit (0 where the chunk lacks the target).
template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_partial_kernel(const T* __restrict__ h, const T* __restrict__ w,
                    const int* __restrict__ y, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_t,
                    int n_rows, int V, int d, int per_chunk) {
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.x * kBM;
  const int chunk = blockIdx.y;
  const int vocab_tiles = (V + kBN - 1) / kBN;
  const int vt_end = min((chunk + 1) * per_chunk, vocab_tiles);

  float run_m[4], run_l[4], run_t[4];
  int tgt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run_m[i] = -INFINITY;
    run_l[i] = 0.f;
    run_t[i] = 0.f;
    const int t = t0 + ty * 4 + i;
    tgt[i] = t < n_rows ? y[t] : -1;
  }

  for (int vt = chunk * per_chunk; vt < vt_end; ++vt) {
    const int v0 = vt * kBN;
    float acc[4][4];
    logit_tile(h, w, n_rows, V, d, t0, v0, s, acc);
    // fold the tile into each row's running statistics; the 16 threads of
    // a row (same ty) are 16 consecutive lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4];
      float tm = -INFINITY, tt = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx * 4 + j;
        x[j] = col < V ? acc[i][j] : -INFINITY;
        tm = fmaxf(tm, x[j]);
        if (col == tgt[i]) tt = acc[i][j];
      }
      for (int o = 8; o > 0; o >>= 1) {
        tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, o));
        tt += __shfl_xor_sync(kFull, tt, o);
      }
      run_t[i] += tt;
      if (tm == -INFINITY) continue;  // a tile of padding only (uniform)
      const float m_new = fmaxf(run_m[i], tm);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps += x[j] == -INFINITY ? 0.f : expf(x[j] - m_new);
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(kFull, ps, o);
      const float alpha =
          run_m[i] == -INFINITY ? 0.f : expf(run_m[i] - m_new);
      run_l[i] = run_l[i] * alpha + ps;
      run_m[i] = m_new;
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t < n_rows) {
        const long long o = (long long)chunk * n_rows + t;
        part_m[o] = run_m[i];
        part_l[o] = run_l[i];
        part_t[o] = run_t[i];
      }
    }
  }
}

// one thread per row: merge the chunk partials in vocab order
__global__ void xent_merge_kernel(const float* __restrict__ part_m,
                                  const float* __restrict__ part_l,
                                  const float* __restrict__ part_t,
                                  float* __restrict__ loss,
                                  float* __restrict__ logz, int n_rows,
                                  int n_chunks) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows) return;
  float m = -INFINITY, l = 0.f, tl = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const long long o = (long long)c * n_rows + t;
    tl += part_t[o];
    const float cm = part_m[o];
    if (cm == -INFINITY) continue;
    const float m_new = fmaxf(m, cm);
    l = (m == -INFINITY ? 0.f : l * expf(m - m_new)) +
        part_l[o] * expf(cm - m_new);
    m = m_new;
  }
  const float z = m + logf(fmaxf(l, 1e-30f));
  logz[t] = z;
  loss[t] = z - tl;
}

// ---------------------------------------------------------------------------
// backward, per vocab chunk [v0, v0 + cw)
// ---------------------------------------------------------------------------
// probs[t, n] = exp(h_t . W_{v0+n} - logz[t]) * g[t], n < cw (the one-hot
// part comes later); probs has row stride `chunk`.
// grid: (ceil(T/64), ceil(cw/64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_probs_kernel(const T* __restrict__ h, const T* __restrict__ w_chunk,
                  const float* __restrict__ logz,
                  const float* __restrict__ g, float* __restrict__ probs,
                  int n_rows, int cw, int d, int chunk) {
  __shared__ __align__(16) Smem s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4];
  logit_tile(h, w_chunk + (long long)n0 * d, n_rows, cw - n0, d, t0, 0, s,
             acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= n_rows) continue;
    const float z = logz[t], gt = g[t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < cw) probs[(long long)t * chunk + n] = expf(acc[i][j] - z) * gt;
    }
  }
}

// dh_acc[t, j] (+)= sum_{n < cw} probs[t, n] * W[v0 + n, j].
// grid: (ceil(T/64), ceil(d/64)); `first` writes instead of adding.
template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_dh_kernel(const float* __restrict__ probs,
               const T* __restrict__ w_chunk, float* __restrict__ dh_acc,
               int n_rows, int cw, int d, int chunk, int first) {
  __shared__ __align__(16) Smem s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4];
  strided_tile<float, T, true, true>(probs, chunk, 1, w_chunk, d, 1, n_rows,
                                     d, cw, m0, n0, s, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = m0 + ty * 4 + i;
    if (t >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= d) continue;
      float* o = dh_acc + (long long)t * d + c;
      *o = first ? acc[i][j] : *o + acc[i][j];
    }
  }
}

// dW[v0 + n, j] = sum_{t < T} (probs[t, n] - 1[v0 + n = y_t] g[t]) h[t, j],
// n < cw. grid: (ceil(cw/64), ceil(d/64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_dw_kernel(const float* __restrict__ probs, const T* __restrict__ h,
               const int* __restrict__ y, const float* __restrict__ g,
               T* __restrict__ dw_chunk, int n_rows, int cw, int d, int v0,
               int chunk) {
  __shared__ __align__(16) Smem s;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  float acc[4][4];
  strided_tile<float, T, false, true, true>(probs, 1, chunk, h, d, 1, cw, d,
                                            n_rows, m0, n0, s, acc, y, g,
                                            v0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = m0 + ty * 4 + i;
    if (n >= cw) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < d) put(dw_chunk + (long long)n * d + c, acc[i][j]);
    }
  }
}

// dh[t, j] = dh_acc[t, j] - g[t] W[y_t, j], in h's dtype.
template <typename T>
__global__ void xent_dh_final_kernel(const float* __restrict__ dh_acc,
                                     const T* __restrict__ w,
                                     const int* __restrict__ y,
                                     const float* __restrict__ g,
                                     T* __restrict__ dh, int n_rows, int V,
                                     int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_rows * d) return;
  const int t = (int)(i / d), j = (int)(i % d);
  const int yt = y[t];
  float x = dh_acc[i];
  if (yt >= 0 && yt < V) x -= g[t] * to_f(w[(long long)yt * d + j]);
  put(dh + i, x);
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kList = 1024;         // one-hot rows scanned per pass
// A warpgroup's 64 output rows are staged in shared memory (rows padded by
// 16 bytes: the fragment's 4-byte writes and the 16-byte reads then hit
// distinct banks) and written out with coalesced 16-byte stores.
constexpr int kProbsRow = 2 * kTile + 16;              // e_hi or e_lo row
constexpr int kProbsSmem = kLogitSmem + 2 * 2 * 64 * kProbsRow;
// products (see GradTile): 4 stages of 48 KB (dh) or 3 of 64 KB (dW); the
// same launch runs probability blocks
constexpr int kGradOwnSmem =
    4 * 3 * kTileBytes + 1024 + 256 + 2 * kList * 4 + 32;
constexpr int kGradSmem = kGradOwnSmem > kProbsSmem ? kGradOwnSmem : kProbsSmem;

// forward: grid (ceil(T / 128), n_chunks); chunk c covers the 128-row vocab
// tiles [c * per_chunk, (c + 1) * per_chunk). Writes per (chunk, row) the
// running max, sum-exp and the target logit (0 where the chunk lacks it).
__global__ void __launch_bounds__(kThreads, 1)
xent_partial_tc(const __grid_constant__ CUtensorMap hmap,
                const __grid_constant__ CUtensorMap wmap,
                const int* __restrict__ y, float* __restrict__ part_m,
                float* __restrict__ part_l, float* __restrict__ part_t,
                int n_rows, int V, int d, int per_chunk) {
  extern __shared__ char smem[];
  char* rest;
  const Ring r = ring_init(smem, kLogitStages, kLogitStage, &rest);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = blockIdx.x * kTile, chunk = blockIdx.y;
  const int vocab_tiles = (V + kTile - 1) / kTile;
  const int vt0 = chunk * per_chunk;
  const int vt1 = min(vt0 + per_chunk, vocab_tiles);
  const int nk = (d + kBK - 1) / kBK;
  Cursor c;
  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      hopper::prefetch_map(&hmap);
      hopper::prefetch_map(&wmap);
      for (int vt = vt0; vt < vt1; ++vt)
        load_logit_tile(r, c, &hmap, &wmap, t0, vt * kTile, nk);
    }
    return;
  }
  const int wg = warp / 4;
  const bool signal = threadIdx.x % 128 == 0;
  float run_m[2], run_l[2], run_t[2];
  int tgt[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t0 + 64 * wg + frag_row(hf, warp, lane);
    run_m[hf] = -INFINITY;
    run_l[hf] = 0.f;
    run_t[hf] = 0.f;
    tgt[hf] = t < n_rows ? y[t] : -1;
  }
  float acc[64] = {};
  for (int vt = vt0; vt < vt1; ++vt) {
    logit_tile(r, c, acc, wg, nk, signal);
    const int v0 = vt * kTile;
    if (v0 + kTile > V) {  // the ragged last tile: padding columns to -inf
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (v0 + frag_col(i, lane) >= V) acc[i] = -INFINITY;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tc = tgt[hf] - v0;
      if ((unsigned)tc < (unsigned)kTile) {  // the tile holds the target
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int i = (j / 2) * 4 + hf * 2 + (j & 1);
          if (frag_col(i, lane) == tc) run_t[hf] += acc[i];
        }
      }
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        tm = fmaxf(tm, acc[(j / 2) * 4 + hf * 2 + (j & 1)]);
      tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, 1));
      tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, 2));
      const float m_new = fmaxf(run_m[hf], tm);
      // exp(x - m) as 2^((x - m) log2 e) on the special-function unit;
      // 2^-inf = 0 takes the padding out
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        ps += hopper::exp2_approx(
            (acc[(j / 2) * 4 + hf * 2 + (j & 1)] - m_new) * kLog2e);
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      const float alpha =
          run_m[hf] == -INFINITY
              ? 0.f
              : hopper::exp2_approx((run_m[hf] - m_new) * kLog2e);
      run_l[hf] = run_l[hf] * alpha + ps;
      run_m[hf] = m_new;
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float tt = run_t[hf];
    tt += __shfl_xor_sync(kFull, tt, 1);
    tt += __shfl_xor_sync(kFull, tt, 2);
    const int t = t0 + 64 * wg + frag_row(hf, warp, lane);
    if ((lane & 3) == 0 && t < n_rows) {
      const long long o = (long long)chunk * n_rows + t;
      part_m[o] = run_m[hf];
      part_l[o] = run_l[hf];
      part_t[o] = tt;
    }
  }
}

// The probabilities of one vocab chunk [v0, v0 + cw): e[t, n] = exp(h_t .
// W_{v0+n} - logz[t]) g[t] for n < cw, 0 for cw <= n < 128 ceil(cw / 128),
// stored as e_hi = bf16(e) and e_lo = bf16(e - e_hi), each (T, C).
struct ProbsArgs {
  const float* logz;
  const float* g;
  bf16* e_hi;
  bf16* e_lo;
  int v0, cw;
  int per_cta;    // 128-column tiles a block
  int row_tiles;  // blocks are (row tile, group of per_cta tiles), row fastest
};

// One block of the probabilities: row tile block % row_tiles, column tiles
// [per_cta * g, per_cta * (g + 1)) with g = block / row_tiles.
__device__ __forceinline__ void probs_block(const CUtensorMap& hmap,
                                            const CUtensorMap& wmap,
                                            const ProbsArgs& pa, int n_rows,
                                            int d, int C, int block) {
  extern __shared__ char smem[];
  char* rest;
  const Ring r = ring_init(smem, kLogitStages, kLogitStage, &rest);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = (block % pa.row_tiles) * kTile;
  const int nt0 = (block / pa.row_tiles) * pa.per_cta;
  const int nt1 = min(nt0 + pa.per_cta, (pa.cw + kTile - 1) / kTile);
  const int nk = (d + kBK - 1) / kBK;
  Cursor c;
  if (warp == kConsumers / 32) {  // producer
    if (lane == 0)
      for (int nt = nt0; nt < nt1; ++nt)
        load_logit_tile(r, c, &hmap, &wmap, t0, pa.v0 + nt * kTile, nk);
    return;
  }
  const int wg = warp / 4;
  float z[2], gt[2];   // rows past T get e = 0
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t0 + 64 * wg + frag_row(hf, warp, lane);
    z[hf] = t < n_rows ? pa.logz[t] : 0.f;
    gt[hf] = t < n_rows ? pa.g[t] : 0.f;
  }
  // [hi, lo][64 rows] of this warpgroup, after the ring's barriers
  char* stage_out = rest + wg * 2 * 64 * kProbsRow;
  const int tid = threadIdx.x % 128;
  float acc[64] = {};
  for (int nt = nt0; nt < nt1; ++nt) {
    logit_tile(r, c, acc, wg, nk, tid == 0);
    const int n0 = nt * kTile;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lr = frag_row(hf, warp, lane);
      char* hi_row = stage_out + lr * kProbsRow;
      char* lo_row = hi_row + 64 * kProbsRow;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int i = 4 * q + 2 * hf;
        const int col = frag_col(i, lane), n = n0 + col;
        const float e0 =
            n < pa.cw
                ? hopper::exp2_approx((acc[i] - z[hf]) * kLog2e) * gt[hf]
                : 0.f;
        const float e1 =
            n + 1 < pa.cw
                ? hopper::exp2_approx((acc[i + 1] - z[hf]) * kLog2e) * gt[hf]
                : 0.f;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(e0, e1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            e0 - __low2float(hi), e1 - __high2float(hi));
        *reinterpret_cast<__nv_bfloat162*>(hi_row + 2 * col) = hi;
        *reinterpret_cast<__nv_bfloat162*>(lo_row + 2 * col) = lo;
      }
    }
    hopper::named_sync(1 + wg, 128);
    // 2 arrays x 64 rows x 16 chunks of 16 bytes
    for (int x = tid; x < 2 * 64 * 16; x += 128) {
      const int lo = x >= 64 * 16, lr = (x / 16) % 64, ch = x % 16;
      const int t = t0 + 64 * wg + lr;
      if (t < n_rows)
        *reinterpret_cast<uint4*>((lo ? pa.e_lo : pa.e_hi) +
                                  (long long)t * C + n0 + 8 * ch) =
            *reinterpret_cast<const uint4*>(stage_out +
                                            (lo * 64 + lr) * kProbsRow +
                                            16 * ch);
    }
    hopper::named_sync(1 + wg, 128);  // the staging is rewritten next tile
  }
}

// The first chunk's probabilities; later chunks' ride in xent_grad_tc.
__global__ void __launch_bounds__(kThreads, 1)
xent_probs_tc(const __grid_constant__ CUtensorMap hmap,
              const __grid_constant__ CUtensorMap wmap, ProbsArgs pa,
              int n_rows, int d, int C) {
  probs_block(hmap, wmap, pa, n_rows, d, C, blockIdx.x);
}

// Both gradient products of one vocab chunk [v0, v0 + cw) from its pair
// e_hi, e_lo (hi_map, lo_map), 128 x 128 output tiles, d in 128-column
// tiles:
//  - dh: dh_acc[t, j] (+)= sum_{n < cw} e[t, n] W[v0 + n, j], K = the
//    chunk, e K-major and W MN-major; `first` writes instead of adding;
//  - dW: dW[v0 + n, j] = sum_t e[t, n] h[t, j] - sum_{t: y_t = v0 + n}
//    g[t] h[t, j], K = T, e and h MN-major, in h's dtype.
// e enters as e_hi and e_lo, two wgmma passes into one fp32 accumulator.
// Warp q of a warpgroup lists, in order of t, the t in its quarter of
// [s0, s1) whose target y[t] lies in [vlo, vhi): list[q * kList / 4 ..],
// count[q]. The four quarters in order of q are the targets in order of t.
__device__ __forceinline__ void scan_targets(const int* __restrict__ y,
                                             int* list, int* count, int s0,
                                             int s1, int vlo, int vhi, int q,
                                             int lane) {
  constexpr int kPart = kList / 4, kLoads = kPart / 32;
  const int b0 = s0 + q * kPart, b1 = min(b0 + kPart, s1);
  int yy[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {  // all loads in flight at once
    const int t = b0 + 32 * u + lane;
    yy[u] = t < b1 ? y[t] : -1;
  }
  int n = 0;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const bool hit = yy[u] >= vlo && yy[u] < vhi;
    const unsigned bits = __ballot_sync(kFull, hit);
    if (hit)
      list[q * kPart + n + __popc(bits & ((1u << lane) - 1))] =
          b0 + 32 * u + lane;
    n += __popc(bits);
  }
  if (lane == 0) count[q] = n;
}

struct GradArgs {
  const int* y;
  const float* g;
  const bf16* h;
  float* dh_acc;
  bf16* dw;
  int v0, cw, first;
};

// The shape of a product tile: 128 output rows (two warpgroups of 64) by
// kN columns of d, a ring of kStages stages, each e_hi, e_lo (128 x 64) and
// the other operand (64 x kN, MN-major, in 64-column boxes).
//  - dh: kN = 128, 56 tiles at T = 1,024 each summing the whole chunk
//    (K = C), so many tiles keep the card busy; A = e K-major.
//  - dW: kN = 224, d = 896 in 4 tiles, K = T: fewer, wider tiles read e
//    once for 224 columns; A = e^T, MN-major.
template <bool DH>
struct GradTile {
  static constexpr int kN = DH ? 128 : 224;
  static constexpr int kBoxesB = (kN + 63) / 64;
  static constexpr int kStage = 2 * kTileBytes + kBoxesB * hopper::kBoxBytes;
  static constexpr int kStages = DH ? 4 : 3;
  static_assert(kStages * kStage <= 4 * 3 * kTileBytes, "see kGradSmem");
};

template <bool DH>
__device__ __forceinline__ void grad_tile(const CUtensorMap& hmap,
                                          const CUtensorMap& wmap,
                                          const CUtensorMap& hi_map,
                                          const CUtensorMap& lo_map,
                                          const GradArgs& ga, int n_rows,
                                          int d, int tile) {
  using G = GradTile<DH>;
  extern __shared__ char smem[];
  char* rest;
  const Ring r = ring_init(smem, G::kStages, G::kStage, &rest);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d_tiles = (d + G::kN - 1) / G::kN;
  const int m0 = (tile / d_tiles) * kTile;  // rows of T (dh) or the chunk
  const int j0 = (tile % d_tiles) * G::kN;  // columns of d
  const int v0 = ga.v0, cw = ga.cw;
  const int nk = ((DH ? cw : n_rows) + kBK - 1) / kBK;
  Cursor c;
  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        hopper::bar_wait(&r.empty[c.stage], c.phase ^ 1);
        char* st = r.data + c.stage * G::kStage;
        uint64_t* bar = &r.full[c.stage];
        hopper::bar_expect_tx(bar, G::kStage);
        const int k = kb * kBK;
        // e boxes: (chunk column, T row); K-major for dh, MN-major for dW
        const int ei0 = DH ? k : m0, eo0 = DH ? m0 : k;
        const int ei1 = DH ? k : m0 + 64, eo1 = DH ? m0 + 64 : k;
        hopper::tma_load(st, &hi_map, bar, ei0, eo0);
        hopper::tma_load(st + hopper::kBoxBytes, &hi_map, bar, ei1, eo1);
        hopper::tma_load(st + kTileBytes, &lo_map, bar, ei0, eo0);
        hopper::tma_load(st + kTileBytes + hopper::kBoxBytes, &lo_map, bar,
                         ei1, eo1);
        const CUtensorMap* bmap = DH ? &wmap : &hmap;
        const int bo = DH ? v0 + k : k;
#pragma unroll
        for (int x = 0; x < G::kBoxesB; ++x)
          hopper::tma_load(st + 2 * kTileBytes + x * hopper::kBoxBytes, bmap,
                           bar, j0 + 64 * x, bo);
        c.next(G::kStages);
      }
    }
    return;
  }
  const int wg = warp / 4;
  const bool signal = threadIdx.x % 128 == 0;
  const int rbase = m0 + 64 * wg;
  // dW: the targets that fall in this warpgroup's vocab rows, found while
  // the first stages load
  int* list = reinterpret_cast<int*>(rest) + wg * kList;
  int* count = reinterpret_cast<int*>(rest) + 2 * kList + 4 * wg;
  const int vlo = v0 + rbase, vhi = v0 + min(rbase + 64, cw);
  if (!DH)
    scan_targets(ga.y, list, count, 0, min(kList, n_rows), vlo, vhi,
                 warp & 3, lane);
  float acc[G::kN / 2] = {};
  consume<G::kStages, G::kStage>(
      r, c, acc, nk, signal,
      [&](float(&part)[G::kN / 2], const char* st, bool add) {
        const char* ahi = st + wg * hopper::kBoxBytes;
        const char* alo = ahi + kTileBytes;
        const char* b = st + 2 * kTileBytes;
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          const uint64_t db = hopper::desc_mn(b, ks);
          if constexpr (DH) {
            hopper::wgmma_128<0, 1>(part, hopper::desc_k(ahi, ks), db,
                                    add || ks > 0);
            hopper::wgmma_128<0, 1>(part, hopper::desc_k(alo, ks), db, 1);
          } else {
            hopper::wgmma_224<1, 1>(part, hopper::desc_mn(ahi, ks), db,
                                    add || ks > 0);
            hopper::wgmma_224<1, 1>(part, hopper::desc_mn(alo, ks), db, 1);
          }
        }
      });

  if constexpr (DH) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = rbase + frag_row(hf, warp, lane);
      if (t >= n_rows) continue;
#pragma unroll
      for (int q = 0; q < G::kN / 8; ++q) {
        const int i = 4 * q + 2 * hf;
        const int j = j0 + frag_col(i, lane);
        if (j >= d) continue;
        float2* o =
            reinterpret_cast<float2*>(ga.dh_acc + (long long)t * d + j);
        float2 x = ga.first ? make_float2(0.f, 0.f) : *o;
        x.x += acc[i];
        x.y += acc[i + 1];
        *o = x;
      }
    }
    return;
  }
  // the one-hot part of dW: for each target in this warpgroup's 64 vocab
  // rows, in order of t, subtract g[t] h[t, :] from its row (the first
  // kList targets were scanned before the products)
  for (int s0 = 0; s0 < n_rows; s0 += kList) {
    if (s0 > 0) {
      hopper::named_sync(1 + wg, 128);  // the list is rewritten
      scan_targets(ga.y, list, count, s0, min(s0 + kList, n_rows), vlo, vhi,
                   warp & 3, lane);
    }
    hopper::named_sync(1 + wg, 128);
    for (int q = 0; q < 4; ++q) {
      const int n = count[q];
      for (int m = 0; m < n; ++m) {
        const int t = list[q * (kList / 4) + m];
        const int row = ga.y[t] - vlo;
        const float gt = ga.g[t];
        const bf16* ht = ga.h + (long long)t * d;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (row != frag_row(hf, warp, lane)) continue;
#pragma unroll
          for (int q2 = 0; q2 < G::kN / 8; ++q2) {
            const int i = 4 * q2 + 2 * hf;
            const int j = j0 + frag_col(i, lane);
            if (j >= d) continue;
            const float2 hv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(ht + j));
            acc[i] -= gt * hv.x;
            acc[i + 1] -= gt * hv.y;
          }
        }
      }
    }
  }
  // stage the tile in the ring (free once both warpgroups are done with
  // it), then coalesced 16-byte stores
  constexpr int kRow = 2 * G::kN + 16;
  hopper::named_sync(3, kConsumers);
  char* stage_out = r.data + wg * 64 * kRow;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    char* row = stage_out + frag_row(hf, warp, lane) * kRow;
#pragma unroll
    for (int q = 0; q < G::kN / 8; ++q) {
      const int i = 4 * q + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(row + 2 * frag_col(i, lane)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
  hopper::named_sync(1 + wg, 128);
  constexpr int kChunks = G::kN / 8;   // 16-byte chunks of a row
  for (int x = threadIdx.x % 128; x < 64 * kChunks; x += 128) {
    const int lr = x / kChunks, ch = x % kChunks;
    const int n = rbase + lr, j = j0 + 8 * ch;
    if (n < cw && j < d)
      *reinterpret_cast<uint4*>(ga.dw + (long long)(v0 + n) * d + j) =
          *reinterpret_cast<const uint4*>(stage_out + lr * kRow + 16 * ch);
  }
}

// One launch per vocab chunk c: blocks [0, n_dh) are chunk c's dh tiles,
// the next n_dw blocks its dW tiles, the rest chunk c + 1's probabilities
// (into the other half of the double-buffered scratch), one logit tile
// each. Longest first: the dh tiles sum the whole chunk, the dW tiles T
// rows; the short probability blocks fill the SMs' tails.
__global__ void __launch_bounds__(kThreads, 1)
xent_grad_tc(const __grid_constant__ CUtensorMap hmap,
             const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ CUtensorMap hi_map,
             const __grid_constant__ CUtensorMap lo_map, GradArgs ga,
             ProbsArgs next, int n_dh, int n_dw, int n_rows, int d,
             int C) {
  const int b = blockIdx.x;
  if (b < n_dh)
    grad_tile<true>(hmap, wmap, hi_map, lo_map, ga, n_rows, d, b);
  else if (b < n_dh + n_dw)
    grad_tile<false>(hmap, wmap, hi_map, lo_map, ga, n_rows, d, b - n_dh);
  else
    probs_block(hmap, wmap, next, n_rows, d, C, b - n_dh - n_dw);
}

cudaError_t forward(const void* h, const void* w, const void* y, void* loss,
                    void* logz, void* part_m, void* part_l, void* part_t,
                    int n_rows, int V, int d, int per_chunk, int n_chunks,
                    cudaStream_t stream) {
  CUtensorMap hmap, wmap;
  if (!hopper::make_map(&hmap, h, n_rows, d, d) ||
      !hopper::make_map(&wmap, w, V, d, d))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      xent_partial_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLogitSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rows + kTile - 1) / kTile, n_chunks);
  xent_partial_tc<<<grid, kThreads, kLogitSmem, stream>>>(
      hmap, wmap, static_cast<const int*>(y), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_t), n_rows, V, d,
      per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_merge_kernel<<<(n_rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_t), static_cast<float*>(loss),
      static_cast<float*>(logz), n_rows, n_chunks);
  return cudaGetLastError();
}

// scratch: two chunks' pairs, [buffer][hi, lo][T][C] bf16 (8 T C bytes);
// chunk c's pair is in buffer c % 2.
cudaError_t backward(const void* h, const void* w, const void* y,
                     const void* logz, const void* g, void* dh, void* dw,
                     float* dh_acc, bf16* scratch, int n_rows, int V, int d,
                     int C, cudaStream_t stream) {
  const long long plane = (long long)n_rows * C;
  CUtensorMap hmap, wmap, hi_map[2], lo_map[2];
  if (!hopper::make_map(&hmap, h, n_rows, d, d) ||
      !hopper::make_map(&wmap, w, V, d, d))
    return cudaErrorInvalidValue;
  for (int b = 0; b < 2; ++b)
    if (!hopper::make_map(&hi_map[b], scratch + 2 * b * plane, n_rows, C, C) ||
        !hopper::make_map(&lo_map[b], scratch + (2 * b + 1) * plane, n_rows,
                          C, C))
      return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      xent_probs_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kProbsSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(xent_grad_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGradSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int row_tiles = (n_rows + kTile - 1) / kTile;
  const int dh_n = GradTile<true>::kN, dw_n = GradTile<false>::kN;
  const int n_dh = row_tiles * ((d + dh_n - 1) / dh_n);
  const int dw_d_tiles = (d + dw_n - 1) / dw_n;
  // the probabilities of chunk c
  const int groups = max(1, n_sms / row_tiles);
  auto probs = [&](int c, int* n_blocks) {
    ProbsArgs pa;
    pa.logz = static_cast<const float*>(logz);
    pa.g = static_cast<const float*>(g);
    pa.e_hi = scratch + 2 * (c % 2) * plane;
    pa.e_lo = pa.e_hi + plane;
    pa.v0 = c * C;
    pa.cw = min(C, V - pa.v0);
    const int col_tiles = (pa.cw + kTile - 1) / kTile;
    // alone (the first chunk), about one block per SM; beside the product
    // tiles, one tile a block, which fills the SMs' tails best
    pa.per_cta = c == 0 ? (col_tiles + groups - 1) / groups : 1;
    pa.row_tiles = row_tiles;
    *n_blocks = row_tiles * ((col_tiles + pa.per_cta - 1) / pa.per_cta);
    return pa;
  };
  int n_probs = 0;
  const ProbsArgs first = probs(0, &n_probs);
  xent_probs_tc<<<n_probs, kThreads, kProbsSmem, stream>>>(
      hmap, wmap, first, n_rows, d, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_chunks = (V + C - 1) / C;
  for (int c = 0; c < n_chunks; ++c) {
    GradArgs ga;
    ga.y = static_cast<const int*>(y);
    ga.g = static_cast<const float*>(g);
    ga.h = static_cast<const bf16*>(h);
    ga.dh_acc = dh_acc;
    ga.dw = static_cast<bf16*>(dw);
    ga.v0 = c * C;
    ga.cw = min(C, V - ga.v0);
    ga.first = c == 0;
    ProbsArgs next = first;
    n_probs = 0;
    if (c + 1 < n_chunks) next = probs(c + 1, &n_probs);
    const int n_dw = dw != nullptr ? (ga.cw + kTile - 1) / kTile * dw_d_tiles
                                   : 0;
    xent_grad_tc<<<n_dh + n_probs + n_dw, kThreads, kGradSmem, stream>>>(
        hmap, wmap, hi_map[c % 2], lo_map[c % 2], ga, next, n_dh, n_dw,
        n_rows, d, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n = (long long)n_rows * d;
  xent_dh_final_kernel<bf16><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dh_acc, static_cast<const bf16*>(w), static_cast<const int*>(y),
      static_cast<const float*>(g), static_cast<bf16*>(dh), n_rows, V, d);
  return cudaGetLastError();
}

}  // namespace tc

namespace {

template <typename T>
cudaError_t forward(const void* h, const void* w, const void* y, void* loss,
                    void* logz, void* part_m, void* part_l, void* part_t,
                    int n_rows, int V, int d, int per_chunk, int n_chunks,
                    cudaStream_t stream) {
  const dim3 grid((n_rows + kBM - 1) / kBM, n_chunks);
  xent_partial_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const int*>(y), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_t), n_rows, V, d,
      per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xent_merge_kernel<<<(n_rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_t), static_cast<float*>(loss),
      static_cast<float*>(logz), n_rows, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* h_, const void* w_, const void* y,
                     const void* logz, const void* g, void* dh, void* dw,
                     float* dh_acc, float* probs, int n_rows, int V, int d,
                     int chunk, cudaStream_t stream) {
  const T* h = static_cast<const T*>(h_);
  const T* w = static_cast<const T*>(w_);
  const int row_tiles = (n_rows + kBM - 1) / kBM;
  const int d_tiles = (d + kBN - 1) / kBN;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int cw = min(chunk, V - v0);
    const int col_tiles = (cw + kBN - 1) / kBN;
    const T* w_chunk = w + (long long)v0 * d;
    xent_probs_kernel<T><<<dim3(row_tiles, col_tiles), kThreads, 0,
                           stream>>>(
        h, w_chunk, static_cast<const float*>(logz),
        static_cast<const float*>(g), probs, n_rows, cw, d, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xent_dh_kernel<T><<<dim3(row_tiles, d_tiles), kThreads, 0, stream>>>(
        probs, w_chunk, dh_acc, n_rows, cw, d, chunk, v0 == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (dw != nullptr) {
      xent_dw_kernel<T><<<dim3(col_tiles, d_tiles), kThreads, 0, stream>>>(
          probs, h, static_cast<const int*>(y), static_cast<const float*>(g),
          static_cast<T*>(dw) + (long long)v0 * d, n_rows, cw, d, v0, chunk);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const long long n = (long long)n_rows * d;
  xent_dh_final_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dh_acc, w, static_cast<const int*>(y), static_cast<const float*>(g),
      static_cast<T*>(dh), n_rows, V, d);
  return cudaGetLastError();
}

}  // namespace

// h (T, d) and w (V, d) contiguous, one dtype, 16-byte aligned, d % 8 == 0;
// y (T,) int32; loss and logz (T,) fp32 outputs; part_m/part_l/part_t
// (n_chunks, T) fp32 scratch, the vocab split into n_chunks chunks of
// per_chunk tiles (128 vocab rows a tile in bf16, 64 in fp32). bf16 runs on
// the tensor cores, fp32 on CUDA cores. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (cudaErrorInvalidValue if a TMA
// tensor map is refused).
extern "C" int xent_forward(const void* h, const void* w, const void* y,
                            void* loss, void* logz, void* part_m,
                            void* part_l, void* part_t, int n_rows, int V,
                            int d, int per_chunk, int n_chunks, int is_bf16,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tc::forward(h, w, y, loss, logz, part_m, part_l, part_t, n_rows,
                       V, d, per_chunk, n_chunks, s);
  return forward<float>(h, w, y, loss, logz, part_m, part_l, part_t, n_rows,
                        V, d, per_chunk, n_chunks, s);
}

// As above, plus logz and g (T,) fp32; dh (T, d) in h's dtype and dw (V, d)
// in w's dtype (outputs; dw may be null: no dW); dh_acc (T, d) fp32 scratch;
// probs scratch: in fp32 a (T, chunk) fp32 probability chunk (4 T chunk
// bytes), in bf16 two chunks' pairs e_hi, e_lo, (2, 2, T, chunk) bf16 (8 T
// chunk bytes). chunk is a multiple of 128.
extern "C" int xent_backward(const void* h, const void* w, const void* y,
                             const void* logz, const void* g, void* dh,
                             void* dw, void* dh_acc, void* probs, int n_rows,
                             int V, int d, int chunk, int is_bf16,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(dh_acc);
  if (is_bf16)
    return tc::backward(h, w, y, logz, g, dh, dw, acc,
                        static_cast<__nv_bfloat16*>(probs), n_rows, V, d,
                        chunk, s);
  return backward<float>(h, w, y, logz, g, dh, dw, acc,
                         static_cast<float*>(probs), n_rows, V, d, chunk, s);
}
