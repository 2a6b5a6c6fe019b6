// The dropless grouped expert product of a mixture-of-experts FFN, for
// Hopper (sm_90a): every choice of every token, computed once.
//
// Replaces no Pallas kernel: the JAX package runs its MoE as a capacity-
// bounded scatter into an (E, C, d) buffer and one batched product, which
// drops the choices past an expert's capacity and, at the capacity the
// cached decode needs to drop nothing, computes many times the real pairs'
// work (models/moe.py). Here the buffer holds the real (token, choice)
// pairs, grouped by expert, each group padded only to the tile's rows.
//
// What bounds it on this card: at a decode batch, bytes. A forward reads
// every expert an iteration routes to (at some thousands of pairs, all 128
// of a layer, 1.2 GB at SDAR-30B-A3B's widths) and does ~2 pairs * 3 * d *
// f operations with them, far below the ~295 FLOP/byte where the tensor
// cores would be the limit. At an admission's tens of thousands of pairs
// the same product is bound by operations. So the design streams each
// expert's weights through a TMA ring once per row tile, with the tensor
// cores (wgmma) on bf16 operands and fp32 sums, and keeps everything else
// (the routing's layout, the gather, the combine) to one pass each over
// bytes that are small beside the weights.
//
// Five launches a forward, all on the device state, with no host read, so a
// cached forward is captured into the engines' CUDA graphs like any other:
//  - moe_align: one block. Counts the pairs per expert (shared-memory
//    atomics; the order of rows inside an expert's group is whatever the
//    atomics give, which changes no value: each row of a product depends on
//    its own input row only), pads each count to the tile's 128 rows, scans
//    the padded counts into each group's first row, and writes each pair's
//    row, each row tile's expert and real rows, and the number of tiles.
//    The buffers are sized by the static bound T k + E (128 - 1) rows; the
//    products' grids cover it, and tiles past the count exit at once. It
//    also adds the counts into a device-side tally (pairs per expert, and
//    the padded rows) that the host reads outside the steps.
//  - moe_gather: each pair's token row copied into its row (16-byte
//    vectors). Padding rows are left unwritten: their products are never
//    read.
//  - moe_gate_up: per (row tile, 64 columns of f), the tile's 128 rows
//    against its expert's gate and up matrices, as one m64n128 product per
//    warpgroup whose first 64 columns are the gate's and last 64 the up's;
//    epilogue silu(g) u, rounded to bf16 where the plain path rounds
//    (g and u, silu(g), the product).
//  - moe_down: per (row tile, 128 columns of d), the tile's rows of
//    silu(g) u against the expert's down matrix, rounded to bf16.
//  - moe_combine: each token's k outputs weighted by their gates in fp32 and
//    summed in choice order, with no atomics, rounded to bf16 once.
// The products: one producer warp keeps a ring of 3 stages of 64-deep
// k-slices in flight by TMA (the rows' 128 x 64 tile and the expert's
// 64 x 128 tile, 32 KB), two consumer warpgroups of 64 rows each issue
// wgmma on what has landed, and write their real rows. Two blocks share an
// SM, so one's loads run while the other starts or writes its tile (1-5%
// faster than 4 stages and one block, at 8,192 to 524,288 pairs). The grid
// runs the column tiles of one row tile next to each other, so an expert's
// weights are read from device memory about once per row tile and the next
// row tile of the same expert finds them in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"
#include "../../common/csrc/tc_mainloop.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;                 // rows of a tile (2 warpgroups)
constexpr int kBK = 64;                  // depth of a stage
constexpr int kStages = 3;
constexpr int kBlocksPerSm = 2;          // 2 x 97 KB of shared memory
constexpr int kStage = 2 * tc::kTileBytes;  // A 128 x 64 + B 64 x 128
constexpr int kSmem = kStages * kStage + 1024 + 256;
constexpr int kThreads = tc::kThreads;   // 2 consumer warpgroups + producer
constexpr int kAlignThreads = 1024;
constexpr int kVecThreads = 256;

__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(in[2 * j], in[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// PyTorch's silu on bf16: x / (1 + exp(-x)) in fp32, rounded.
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float gb = round_bf16(g);
  const float a = round_bf16(gb / (1.0f + expf(-gb)));
  return __fmul_rn(a, round_bf16(u));
}

}  // namespace

// ids (n_pairs,) int64 expert of each pair (token-major: pair p is choice
// p % k of token p / k). Writes row_of (n_pairs,), tile_expert and
// tile_rows (one per row tile, up to the static bound), n_tiles (1,); adds
// the counts into tally[0..E) and the padded rows into tally[E] (tally may
// be null). One block; E <= kAlignThreads. Dynamic shared memory: 2 E ints.
__global__ void __launch_bounds__(kAlignThreads)
moe_align(const int64_t* __restrict__ ids, int n_pairs, int E,
          int* __restrict__ row_of, int* __restrict__ tile_expert,
          int* __restrict__ tile_rows, int* __restrict__ n_tiles,
          long long* __restrict__ tally) {
  extern __shared__ int sm[];
  int* cnt = sm;
  int* off = sm + E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) cnt[e] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x)
    row_of[p] = atomicAdd(&cnt[static_cast<int>(ids[p])], 1);
  __syncthreads();
  if (threadIdx.x < 32) {  // one warp scans the padded counts
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + lane;
      const int v = e < E ? (cnt[e] + kBM - 1) / kBM * kBM : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (e < E) off[e] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      *n_tiles = carry / kBM;
      if (tally != nullptr) tally[E] += carry;
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x)
    row_of[p] += off[static_cast<int>(ids[p])];
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int c = cnt[e];
    if (tally != nullptr) tally[e] += c;
    for (int t = off[e] / kBM, left = c; left > 0; ++t, left -= kBM) {
      tile_expert[t] = e;
      tile_rows[t] = min(left, kBM);
    }
  }
}

// xs[row_of[p]] = x[p / k], rows of d bf16 (d % 8 == 0). One block a pair.
__global__ void __launch_bounds__(kVecThreads)
moe_gather(const bf16* __restrict__ x, const int* __restrict__ row_of,
           int k, int d, bf16* __restrict__ xs) {
  const int p = blockIdx.x;
  const bf16* src = x + static_cast<int64_t>(p / k) * d;
  bf16* dst = xs + static_cast<int64_t>(row_of[p]) * d;
  for (int v = threadIdx.x * 8; v < d; v += blockDim.x * 8)
    *reinterpret_cast<uint4*>(dst + v) = *reinterpret_cast<const uint4*>(src + v);
}

// out[t] = bf16(sum_j gates[t, j] y[row_of[t k + j]]), the sum in fp32 in
// choice order. One block a token.
__global__ void __launch_bounds__(kVecThreads)
moe_combine(const bf16* __restrict__ y, const int* __restrict__ row_of,
            const float* __restrict__ gates, int k, int d,
            bf16* __restrict__ out) {
  const int t = blockIdx.x;
  for (int v = threadIdx.x * 8; v < d; v += blockDim.x * 8) {
    float acc[8] = {};
    for (int j = 0; j < k; ++j) {
      const float g = gates[static_cast<int64_t>(t) * k + j];
      float yv[8];
      load8(y + static_cast<int64_t>(row_of[static_cast<int64_t>(t) * k + j]) * d + v, yv);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(yv[i], g));
    }
    store8(out + static_cast<int64_t>(t) * d + v, acc);
  }
}

namespace {

// One (row tile, column tile) of a grouped product: rows [t 128, t 128 +
// 128) of A (K-major, `amap`) against expert e's K x N matrix (N
// contiguous: rows e K .. of `bmap0` / `bmap1`). GATED: the 128 columns are
// bmap0's (the gate's) n0 .. n0 + 63, then bmap1's (the up's) same
// columns, and out (rows, ld) gets silu(g) u at columns n0 ..; otherwise
// bmap0's n0 .. n0 + 127, written as they are.
template <bool GATED>
__device__ __forceinline__ void grouped_tile(
    const CUtensorMap* amap, const CUtensorMap* bmap0,
    const CUtensorMap* bmap1, const int* __restrict__ tile_expert,
    const int* __restrict__ tile_rows, const int* __restrict__ n_tiles,
    bf16* __restrict__ out, int ld, int K, int n0) {
  const int t = blockIdx.y;
  if (t >= *n_tiles) return;  // past the routed rows: the whole block leaves
  const int e = tile_expert[t], rows = tile_rows[t];
  const int row0 = t * kBM;
  extern __shared__ char smem[];
  char* rest;
  const tc::Ring r = tc::ring_init(smem, kStages, kStage, &rest);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = K / kBK;
  tc::Cursor c;
  if (warp == tc::kConsumers / 32) {  // producer
    if (lane == 0) {
      hopper::prefetch_map(amap);
      hopper::prefetch_map(bmap0);
      if (GATED) hopper::prefetch_map(bmap1);
      for (int kb = 0; kb < nk; ++kb) {
        hopper::bar_wait(&r.empty[c.stage], c.phase ^ 1);
        char* st = r.data + c.stage * kStage;
        uint64_t* bar = &r.full[c.stage];
        hopper::bar_expect_tx(bar, kStage);
        const int k = kb * kBK;
        hopper::tma_load(st, amap, bar, k, row0);
        hopper::tma_load(st + hopper::kBoxBytes, amap, bar, k, row0 + 64);
        char* b = st + tc::kTileBytes;
        hopper::tma_load(b, bmap0, bar, n0, e * K + k);
        if (GATED)
          hopper::tma_load(b + hopper::kBoxBytes, bmap1, bar, n0, e * K + k);
        else
          hopper::tma_load(b + hopper::kBoxBytes, bmap0, bar, n0 + 64,
                           e * K + k);
        c.next(kStages);
      }
    }
    return;
  }
  const int wg = warp / 4;
  const bool signal = threadIdx.x % 128 == 0;
  float acc[64] = {};
  // every warpgroup issues its products, padding rows or not: a wgmma on a
  // divergent path is serialized by ptxas
  tc::consume<kStages, kStage>(
      r, c, acc, nk, signal, [&](float(&d)[64], const char* st, bool add) {
        const char* a = st + wg * hopper::kBoxBytes;
        const char* b = st + tc::kTileBytes;
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          hopper::wgmma_128<0, 1>(d, hopper::desc_k(a, ks),
                                  hopper::desc_mn(b, ks), add || ks > 0);
      });
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = 64 * wg + tc::frag_row(hf, warp, lane);
    if (row >= rows) continue;
    bf16* o = out + static_cast<int64_t>(row0 + row) * ld + n0;
#pragma unroll
    for (int q = 0; q < (GATED ? 8 : 16); ++q) {
      const int i = 4 * q + 2 * hf;
      const int col = tc::frag_col(i, lane);
      float v0, v1;
      if constexpr (GATED) {
        v0 = silu_mul(acc[i], acc[i + 32]);
        v1 = silu_mul(acc[i + 1], acc[i + 33]);
      } else {
        v0 = acc[i];
        v1 = acc[i + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

}  // namespace

// grid (f / 64, max row tiles): h (rows, f) = silu(xs W_gate[e]) * (xs
// W_up[e]) for each row tile's expert e.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
moe_gate_up(const __grid_constant__ CUtensorMap amap,
            const __grid_constant__ CUtensorMap gmap,
            const __grid_constant__ CUtensorMap umap,
            const int* __restrict__ tile_expert,
            const int* __restrict__ tile_rows, const int* __restrict__ n_tiles,
            bf16* __restrict__ h, int f, int d) {
  grouped_tile<true>(&amap, &gmap, &umap, tile_expert, tile_rows, n_tiles, h,
                     f, d, blockIdx.x * 64);
}

// grid (d / 128, max row tiles): y (rows, d) = h W_down[e].
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
moe_down(const __grid_constant__ CUtensorMap amap,
         const __grid_constant__ CUtensorMap wmap,
         const int* __restrict__ tile_expert,
         const int* __restrict__ tile_rows, const int* __restrict__ n_tiles,
         bf16* __restrict__ y, int d, int f) {
  grouped_tile<false>(&amap, &wmap, &wmap, tile_expert, tile_rows, n_tiles,
                      y, d, f, blockIdx.x * 128);
}

// ---------------------------------------------------------------------------
// Entry points. Every pointer 16-byte aligned, every tensor contiguous; the
// wrapper checks d % 128 == 0, f % 64 == 0 and E <= 1024, and sizes the
// buffers by the static bound `max_tiles` * 128 rows. Each returns
// cudaGetLastError() (cudaErrorInvalidValue if a tensor map is refused).
// ---------------------------------------------------------------------------
extern "C" int moe_align_launch(const void* ids, int n_pairs, int E,
                                void* row_of, void* tile_expert,
                                void* tile_rows, void* n_tiles, void* tally,
                                void* stream) {
  moe_align<<<1, kAlignThreads, 2 * E * sizeof(int),
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ids), n_pairs, E, static_cast<int*>(row_of),
      static_cast<int*>(tile_expert), static_cast<int*>(tile_rows),
      static_cast<int*>(n_tiles), static_cast<long long*>(tally));
  return cudaGetLastError();
}

extern "C" int moe_gather_launch(const void* x, const void* row_of,
                                 int n_pairs, int k, int d, void* xs,
                                 void* stream) {
  if (n_pairs == 0) return cudaSuccess;
  moe_gather<<<n_pairs, kVecThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(row_of), k, d,
      static_cast<bf16*>(xs));
  return cudaGetLastError();
}

// wg, wu (E, d, f); xs (max_tiles 128, d); h (max_tiles 128, f).
extern "C" int moe_gate_up_launch(const void* xs, const void* wg,
                                  const void* wu, const void* tile_expert,
                                  const void* tile_rows, const void* n_tiles,
                                  void* h, int max_tiles, int E, int d, int f,
                                  void* stream) {
  if (max_tiles == 0) return cudaSuccess;
  CUtensorMap amap, gmap, umap;
  if (!hopper::make_map(&amap, xs, max_tiles * kBM, d, d) ||
      !hopper::make_map(&gmap, wg, E * d, f, f) ||
      !hopper::make_map(&umap, wu, E * d, f, f))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      moe_gate_up, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  moe_gate_up<<<dim3(f / 64, max_tiles), kThreads, kSmem,
                static_cast<cudaStream_t>(stream)>>>(
      amap, gmap, umap, static_cast<const int*>(tile_expert),
      static_cast<const int*>(tile_rows), static_cast<const int*>(n_tiles),
      static_cast<bf16*>(h), f, d);
  return cudaGetLastError();
}

// wo (E, f, d); h (max_tiles 128, f); y (max_tiles 128, d).
extern "C" int moe_down_launch(const void* h, const void* wo,
                               const void* tile_expert, const void* tile_rows,
                               const void* n_tiles, void* y, int max_tiles,
                               int E, int d, int f, void* stream) {
  if (max_tiles == 0) return cudaSuccess;
  CUtensorMap amap, wmap;
  if (!hopper::make_map(&amap, h, max_tiles * kBM, f, f) ||
      !hopper::make_map(&wmap, wo, E * f, d, d))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      moe_down, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  moe_down<<<dim3(d / 128, max_tiles), kThreads, kSmem,
             static_cast<cudaStream_t>(stream)>>>(
      amap, wmap, static_cast<const int*>(tile_expert),
      static_cast<const int*>(tile_rows), static_cast<const int*>(n_tiles),
      static_cast<bf16*>(y), d, f);
  return cudaGetLastError();
}

extern "C" int moe_combine_launch(const void* y, const void* row_of,
                                  const void* gates, int T, int k, int d,
                                  void* out, void* stream) {
  if (T == 0) return cudaSuccess;
  moe_combine<<<T, kVecThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(row_of),
      static_cast<const float*>(gates), k, d, static_cast<bf16*>(out));
  return cudaGetLastError();
}
