// Fused unembed + greedy candidate selection, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/select/select.py::
// select_forward (body _select_kernel): for each row t of hidden states h
// (T, d) it computes the logits h[t] . W[v] over the whole vocabulary and
// returns only the first-occurrence argmax `cand` and its softmax
// probability `conf` = 1 / sum_v exp(logit_v - max), -inf on finalized rows
// (mask == 0). No (T, V) logits tensor is ever written.
//
// What bounds it on this card: at the main path's shapes (T = 8 lanes x 32
// = 256 rows, d = 896, V = 151,936, bf16) the unembedding W is 272 MB, so
// reading it once takes about 81 us at 3.35 TB/s, and the product is
// 70 GFLOP, about 70 us at the tensor cores' 989 TFLOP/s: bytes bound it.
// What the design does, on both routes:
//  - W is read in its (V, d) row layout (the tied token embedding itself):
//    no transposed copy of 272 MB per call;
//  - one row tile alone cannot fill 132 SMs, so the vocabulary is split
//    into chunks across blocks: block (row tile, chunk) walks the logit
//    tiles of its chunk, folds each tile into per-row running (max,
//    sum-exp, argmax) in registers, and writes one (m, l, i) partial per
//    (row, chunk);
//  - blocks that share a chunk are launched next to each other (row tile is
//    the fastest grid axis), so W is read from memory about once and from
//    L2 by the other row tiles;
//  - a second small kernel merges the chunks of each row in vocab order.
// Two routes, chosen by dtype:
//  - bf16 (select_partial_tc, the serving path): the logit tiles are the
//    fused cross-entropy's (../../common/csrc/tc_mainloop.cuh): 128 rows x
//    128 vocab rows, TMA loads of h and W into a 4-stage ring paced by
//    mbarriers, one producer warp and two consumer warpgroups, wgmma with
//    each 64-deep stage's products added into the logits in fp32. A row's
//    128 columns live in the 4 lanes of a quad, 32 each.
//  - fp32 (select_partial_kernel): 64 x 64 logit tiles by a classic
//    shared-memory tiled product on CUDA cores (depth 32, 4 x 4 outputs
//    per thread; 17 KB of shared memory whatever d is); fp32 on the tensor
//    cores would be TF32, three decimal digits.
// Tie rule, as jnp.argmax: within a tile the lowest index of the maximum
// (each thread scans its columns in ascending order keeping a strict >, and
// merging threads take the greater value or, if equal, the lower index);
// across tiles and chunks only a strictly greater maximum replaces the
// running argmax. The final-logit softcap is applied before the vocabulary
// padding mask, as in the JAX kernel; any V works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "../../common/csrc/hopper.cuh"
#include "../../common/csrc/tc_mainloop.cuh"

namespace {

constexpr int kBM = 64;   // hidden rows per block
constexpr int kBN = 64;   // vocab rows per tile
constexpr int kBK = 32;   // depth per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// (max, index) of two candidates; equal maxima keep the lower index
__device__ __forceinline__ void argmax_merge(float& m, int& i, float om,
                                             int oi) {
  if (om > m || (om == m && oi < i)) {
    m = om;
    i = oi;
  }
}

// grid: (ceil(T / kBM), n_chunks); chunk c covers vocab tiles
// [c * per_chunk, (c + 1) * per_chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
select_partial_kernel(const T* __restrict__ h, const T* __restrict__ w,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      int* __restrict__ part_i, int n_rows, int V, int d,
                      int per_chunk, float softcap) {
  __shared__ __align__(16) float sa[kBK][kBM + 4];  // h tile, transposed
  __shared__ __align__(16) float sb[kBK][kBN + 4];  // W tile, transposed
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // vocab direction
  const int ty = tid / 16;  // row direction
  const int t0 = blockIdx.x * kBM;
  const int chunk = blockIdx.y;
  const int vocab_tiles = (V + kBN - 1) / kBN;
  const int vt_end = min((chunk + 1) * per_chunk, vocab_tiles);
  // loader: thread loads 8 consecutive depth elements of one row
  const int ld_row = tid / 4;
  const int ld_k = (tid % 4) * 8;

  float run_m[4], run_l[4];
  int run_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run_m[i] = -INFINITY;
    run_l[i] = 0.f;
    run_i[i] = 0;
  }

  for (int vt = chunk * per_chunk; vt < vt_end; ++vt) {
    const int v0 = vt * kBN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kBK) {
      float xa[8], xb[8];
      const bool k_ok = k0 + ld_k < d;  // d % 8 == 0: all 8 or none
      const int ta = t0 + ld_row, vb = v0 + ld_row;
      if (k_ok && ta < n_rows) load8(h + (long long)ta * d + k0 + ld_k, xa);
      else for (int e = 0; e < 8; ++e) xa[e] = 0.f;
      if (k_ok && vb < V) load8(w + (long long)vb * d + k0 + ld_k, xb);
      else for (int e = 0; e < 8; ++e) xb[e] = 0.f;
      __syncthreads();  // the previous stage is consumed
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sa[ld_k + e][ld_row] = xa[e];
        sb[ld_k + e][ld_row] = xb[e];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&sa[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&sb[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // fold the tile into each row's running statistics; the 16 threads of
    // a row (same ty) are 16 consecutive lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4];
      float tm = -INFINITY;
      int ti = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx * 4 + j;
        float s = acc[i][j];
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        x[j] = col < V ? s : -INFINITY;
        if (x[j] > tm) {  // ascending j: first occurrence
          tm = x[j];
          ti = col;
        }
      }
      for (int o = 8; o > 0; o >>= 1) {
        const float om = __shfl_xor_sync(kFull, tm, o);
        const int oi = __shfl_xor_sync(kFull, ti, o);
        argmax_merge(tm, ti, om, oi);
      }
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
      if (tm > run_m[i]) run_i[i] = ti;  // strict: earlier tiles win ties
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
        part_i[o] = run_i[i];
      }
    }
  }
}

// one thread per row: merge the chunk partials in vocab order
__global__ void select_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const int* __restrict__ part_i,
                                    const int* __restrict__ mask,
                                    int* __restrict__ cand,
                                    float* __restrict__ conf, int n_rows,
                                    int n_chunks) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rows) return;
  float m = -INFINITY, l = 0.f;
  int best = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const long long o = (long long)c * n_rows + t;
    const float cm = part_m[o];
    if (cm == -INFINITY) continue;
    const float m_new = fmaxf(m, cm);
    l = (m == -INFINITY ? 0.f : l * expf(m - m_new)) +
        part_l[o] * expf(cm - m_new);
    if (cm > m) best = part_i[o];  // strict: earlier chunks win ties
    m = m_new;
  }
  cand[t] = best;
  conf[t] = mask[t] != 0 ? 1.f / l : -INFINITY;
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------
// grid: (ceil(T / 128), n_chunks); chunk c covers the 128-row vocab tiles
// [c * per_chunk, (c + 1) * per_chunk).
__global__ void __launch_bounds__(tc::kThreads, 1)
select_partial_tc(const __grid_constant__ CUtensorMap hmap,
                  const __grid_constant__ CUtensorMap wmap,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  int* __restrict__ part_i, int n_rows, int V, int d,
                  int per_chunk, float softcap) {
  extern __shared__ char smem[];
  char* rest;
  const tc::Ring r =
      tc::ring_init(smem, tc::kLogitStages, tc::kLogitStage, &rest);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t0 = blockIdx.x * tc::kTile, chunk = blockIdx.y;
  const int vocab_tiles = (V + tc::kTile - 1) / tc::kTile;
  const int vt0 = chunk * per_chunk;
  const int vt1 = min(vt0 + per_chunk, vocab_tiles);
  const int nk = (d + tc::kBK - 1) / tc::kBK;
  tc::Cursor c;
  if (warp == tc::kConsumers / 32) {  // producer
    if (lane == 0) {
      hopper::prefetch_map(&hmap);
      hopper::prefetch_map(&wmap);
      for (int vt = vt0; vt < vt1; ++vt)
        tc::load_logit_tile(r, c, &hmap, &wmap, t0, vt * tc::kTile, nk);
    }
    return;
  }
  const int wg = warp / 4;
  const bool signal = threadIdx.x % 128 == 0;
  float run_m[2] = {-INFINITY, -INFINITY}, run_l[2] = {0.f, 0.f};
  int run_i[2] = {0, 0};
  float acc[64] = {};
  for (int vt = vt0; vt < vt1; ++vt) {
    tc::logit_tile(r, c, acc, wg, nk, signal);
    const int v0 = vt * tc::kTile;
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = softcap * tanhf(acc[i] / softcap);
    }
    if (v0 + tc::kTile > V) {  // the ragged last tile: padding to -inf
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (v0 + tc::frag_col(i, lane) >= V) acc[i] = -INFINITY;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // this thread's 32 columns of the row, in ascending order
      float tm = -INFINITY;
      int ti = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = (j / 2) * 4 + hf * 2 + (j & 1);
        if (acc[i] > tm) {
          tm = acc[i];
          ti = tc::frag_col(i, lane);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float om = __shfl_xor_sync(kFull, tm, o);
        const int oi = __shfl_xor_sync(kFull, ti, o);
        argmax_merge(tm, ti, om, oi);
      }
      const float m_new = fmaxf(run_m[hf], tm);
      // exp(x - m) as 2^((x - m) log2 e); 2^-inf = 0 takes the padding out
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        ps += hopper::exp2_approx(
            (acc[(j / 2) * 4 + hf * 2 + (j & 1)] - m_new) * tc::kLog2e);
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      const float alpha =
          run_m[hf] == -INFINITY
              ? 0.f
              : hopper::exp2_approx((run_m[hf] - m_new) * tc::kLog2e);
      run_l[hf] = run_l[hf] * alpha + ps;
      if (tm > run_m[hf]) run_i[hf] = v0 + ti;  // strict: earlier tiles win
      run_m[hf] = m_new;
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t0 + 64 * wg + tc::frag_row(hf, warp, lane);
    if ((lane & 3) == 0 && t < n_rows) {
      const long long o = (long long)chunk * n_rows + t;
      part_m[o] = run_m[hf];
      part_l[o] = run_l[hf];
      part_i[o] = run_i[hf];
    }
  }
}

cudaError_t merge(const void* mask, void* cand, void* conf,
                  const void* part_m, const void* part_l, const void* part_i,
                  int n_rows, int n_chunks, cudaStream_t stream) {
  select_merge_kernel<<<(n_rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const int*>(part_i), static_cast<const int*>(mask),
      static_cast<int*>(cand), static_cast<float*>(conf), n_rows, n_chunks);
  return cudaGetLastError();
}

cudaError_t launch_tc(const void* h, const CUtensorMap& wmap,
                      const void* mask, void* cand, void* conf, void* part_m,
                      void* part_l, void* part_i, int n_rows, int V, int d,
                      int per_chunk, int n_chunks, float softcap,
                      cudaStream_t stream) {
  CUtensorMap hmap;
  if (!hopper::make_map(&hmap, h, n_rows, d, d)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      select_partial_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc::kLogitSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rows + tc::kTile - 1) / tc::kTile, n_chunks);
  select_partial_tc<<<grid, tc::kThreads, tc::kLogitSmem, stream>>>(
      hmap, wmap, static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<int*>(part_i), n_rows, V, d, per_chunk, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge(mask, cand, conf, part_m, part_l, part_i, n_rows, n_chunks,
               stream);
}

cudaError_t launch(const void* h, const void* w, const void* mask, void* cand,
                   void* conf, void* part_m, void* part_l, void* part_i,
                   int n_rows, int V, int d, int per_chunk, int n_chunks,
                   float softcap, cudaStream_t stream) {
  const dim3 grid((n_rows + kBM - 1) / kBM, n_chunks);
  select_partial_kernel<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<int*>(part_i), n_rows, V, d, per_chunk, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge(mask, cand, conf, part_m, part_l, part_i, n_rows, n_chunks,
               stream);
}

}  // namespace

// The TMA tensor map of a bf16 unembedding w (V, d) (contiguous, 16-byte
// aligned, d % 8 == 0) into `map` (128 bytes, CUtensorMap): encoded once
// per weight by the caller and handed to every select_forward call.
// Returns 0, or cudaErrorInvalidValue if the driver refuses the map.
extern "C" int select_encode_map(void* map, const void* w, int V, int d) {
  CUtensorMap m;
  if (!hopper::make_map(&m, w, V, d, d)) return cudaErrorInvalidValue;
  memcpy(map, &m, sizeof(m));
  return cudaSuccess;
}

// h (T, d) and w (V, d) contiguous, 16-byte aligned, d % 8 == 0; mask (T,)
// int32; cand (T,) int32 and conf (T,) fp32 outputs; part_m/part_l/part_i
// (n_chunks, T) scratch, allocated by the caller, the vocab split into
// n_chunks chunks of per_chunk tiles (128 vocab rows a tile in bf16, 64 in
// fp32). bf16 runs on the tensor cores and reads w through `wmap`, the map
// select_encode_map made for it (fp32: unused, may be null). softcap <= 0
// means none. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue if h's tensor map is refused).
extern "C" int select_forward(const void* h, const void* w, const void* wmap,
                              const void* mask, void* cand, void* conf,
                              void* part_m, void* part_l, void* part_i,
                              int n_rows, int V, int d, int per_chunk,
                              int n_chunks, float softcap, int is_bf16,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    CUtensorMap m;
    memcpy(&m, wmap, sizeof(m));
    return launch_tc(h, m, mask, cand, conf, part_m, part_l, part_i, n_rows,
                     V, d, per_chunk, n_chunks, softcap, s);
  }
  return launch(h, w, mask, cand, conf, part_m, part_l, part_i, n_rows, V, d,
                per_chunk, n_chunks, softcap, s);
}
