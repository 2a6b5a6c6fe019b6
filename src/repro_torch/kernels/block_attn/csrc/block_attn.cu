// Full-sequence attention with CDLM visibility (bidirectional, causal or
// block-causal), for Hopper (sm_90a): the prompt prefill of every admission
// and the trajectory collector's full-canvas forwards.
//
// Replaces the TPU kernel src/repro/kernels/block_attn/block_attn.py::
// block_attention (body _flash_kernel, visibility _tile_visibility) and the
// padding its wrapper ops.py::flash_block_attention does around it.
//
// The TPU kernel walks a sequential grid axis over key tiles and carries
// (m, l, acc) in scratch from one grid step to the next. Hopper blocks run
// in no order and share nothing, so here one block owns a tile of query
// rows of one (lane, KV head) and loops over the key tiles itself, with the
// online softmax in registers. Both routes:
//  - fold the GQA group into the rows (row = qpos * G + g), so the G query
//    heads that share a KV head share every K/V tile loaded to shared
//    memory, and no G-fold copy of K/V exists;
//  - visit only the key tiles the block's rows can see: up to the end of
//    its last row's CDLM block (causal: its last position), and from
//    q - window + 1 with a window. Inside a tile, visibility is decided per
//    (query, key) exactly as _tile_visibility does: prompt positions form
//    block -1, the others (pos - prompt_len) / block_size; with a window,
//    q - k < window under causal and |q - k| < window otherwise. Softcap
//    comes before the mask; the output is normalized by max(l, 1e-30);
//  - mask the ragged edge of L here (keys at or past L are never visible),
//    so the wrapper pads nothing.
//
// What bounds it on this card: at the prefill shape (8 lanes, 512
// positions, 2 KV heads of 7 query heads, head_dim 64, bf16, everything
// visible) one call does about 7.5 GFLOP and moves about 24 MB: both
// bounds near 7.6 us, at the tensor cores' bf16 rate.
//
// Two routes, chosen by dtype:
//  - bf16 (block_attn_tc, the model's path): the products run on the tensor
//    cores. Block = (128 folded query rows, KV head, lane): two warpgroups
//    of 64 rows, two blocks an SM at hd 64. They load the block's Q once
//    with 16-byte loads straight into the 128-byte-swizzled K-major layout
//    wgmma reads (the folded rows are not a strided matrix when G = 7, so
//    no TMA box fits them); thread 0 streams 64-key K and V tiles by TMA (k
//    and v viewed as (b L, Kv hd) matrices) into a ring of 3 stages, each
//    refilled as soon as both warpgroups are done with it (a producer warp
//    would cost the registers that let two blocks share an SM). Per tile: S = Q K^T by wgmma from shared memory (hd / 16
//    k-steps, fp32 accumulators); scale (in fp32, after the product: 1 /
//    sqrt(hd) is not a power of two, so Q is not pre-scaled in bf16),
//    softcap and mask in registers, the online softmax in base 2 (log2 e
//    folded into the scale), each row's statistics in the 4 lanes of a
//    quad; then O += P V with P from registers (the S accumulator's
//    fragment is the A fragment of the next wgmma) and V MN-major. One bf16
//    rounding of P is 2^-9 relative, about 1e-3 of the output: P goes in as
//    a pair p_hi = bf16(p), p_lo = bf16(p - p_hi), two wgmma passes into one
//    fp32 accumulator, leaving about 2^-18 |p|. Keys past L (the next lane's
//    rows, or TMA's zero fill) get probability exactly 0.
//  - fp32 (block_attn_kernel): one warp owns a query row at a time: lane j
//    scores key j of a 32-key tile, the warp reduces max and sum with
//    shuffles, and each lane keeps hd/32 output columns in registers. CUDA
//    cores in fp32 (the tensor cores' fp32 would be TF32).
//
// Head dims 64, 112, 128 and 256. Two of them do not fit the 128-row,
// three-stage layout as it is:
//  - 112 (kimi-k2) is not a multiple of the 64-value TMA box. K and V come
//    through 3-D tensor maps (rows, KV head, head_dim) whose second box
//    covers columns 64 .. 127: TMA zero-fills those past 112, so no box
//    reads the next head's values. Q is copied zero-padded to 128; S runs 7
//    k-steps over the real columns, P V at N = 128, and columns past 112 are
//    never written. The scale is the caller's (1/sqrt(112)).
//  - 256 (gemma-7b): a 64 x 256 fp32 O would take 128 registers a thread
//    on top of S, and Q for 128 rows plus three K/V stages would not fit
//    227 KB. A block holds 64 rows; its two warpgroups both compute S over
//    all 256 columns and each keeps one 128-column half of O (registers as
//    at head_dim 128), with two stages of 64 KB and 32 KB of Q (166 KB).
//    The fp32 kernel's shared memory at 256 (82 KB) is dynamic, opted into
//    above 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../common/csrc/hopper.cuh"
#include "../../common/csrc/tc_mainloop.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 32;  // keys per shared-memory tile (one per lane)
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kBidirectional = 0, kCausal = 1, kBlockCausal = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int cdlm_block(int pos, int prompt_len,
                                          int block_size) {
  return pos < prompt_len ? -1 : (pos - prompt_len) / block_size;
}

__device__ __forceinline__ bool visible(int qp, int kp, int mode,
                                        int prompt_len, int block_size,
                                        int window) {
  bool vis = true;
  if (mode == kCausal)
    vis = kp <= qp;
  else if (mode == kBlockCausal)
    vis = cdlm_block(kp, prompt_len, block_size) <=
          cdlm_block(qp, prompt_len, block_size);
  if (window > 0)
    vis = vis && (mode == kCausal ? qp - kp < window : abs(qp - kp) < window);
  return vis;
}

// The keys any of the rows [row0, row0 + n) (of `rows`) can see:
// [*k_begin, *k_end).
__device__ __forceinline__ void key_range(int row0, int n, int rows, int G,
                                          int L, int mode, int prompt_len,
                                          int block_size, int window,
                                          int* k_begin, int* k_end) {
  const int q_lo = row0 / G;
  const int q_hi = (min(row0 + n, rows) - 1) / G;
  int kb = 0, ke = L;
  if (mode == kCausal)
    ke = q_hi + 1;
  else if (mode == kBlockCausal)
    ke = prompt_len + (cdlm_block(q_hi, prompt_len, block_size) + 1) *
                          block_size;
  if (window > 0) {
    kb = max(0, q_lo - window + 1);
    if (mode != kCausal) ke = min(ke, q_hi + window);
  }
  *k_begin = kb;
  *k_end = min(ke, L);
}

// Head dims not a multiple of 64 (kimi-k2's 112) run padded to the next
// multiple of 64 in shared memory and registers: the padding is zero, every
// global offset uses the real head_dim, and nothing past it is written.
__host__ __device__ constexpr int padded(int hd) {
  return (hd + 63) / 64 * 64;
}

// Dynamic shared memory of block_attn_kernel: Q (ROWS x P), K (32 x P+1)
// and V (32 x P) in fp32; over 48 KB at head_dim 256, so it is opted into
// at launch.
template <int HD, int ROWS>
constexpr int f32_smem() {
  return (ROWS * padded(HD) + kTileK * (padded(HD) + 1) +
          kTileK * padded(HD)) * 4;
}

// grid: (ceil(L*G / ROWS), Kv, b); block: kThreads. q (b, L, Kv, G, hd),
// k/v (b, L, Kv, hd) contiguous; out (b, L, Kv, G, hd) fp32. Loads and
// stores use HD; the products run over P = padded(HD), whose padding is
// zero.
template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads)
block_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, float* __restrict__ out, int L,
                  int Kv, int G, int mode, int prompt_len, int block_size,
                  int window, float scale, float softcap) {
  constexpr int P = padded(HD);
  constexpr int kRowsPerWarp = ROWS / kWarps;
  constexpr int kColsPerLane = P / 32;
  extern __shared__ float f32_raw[];
  float* sq = f32_raw;                 // [ROWS][P]
  float* sk = sq + ROWS * P;           // [kTileK][P + 1]: lane j reads row
  float* sv = sk + kTileK * (P + 1);   // j conflict-free; [kTileK][P]

  const int rows = L * G;
  const int row0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y;
  const int lb = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int idx = tid; idx < ROWS * P; idx += kThreads) {
    const int r = idx / P, d = idx % P, row = row0 + r;
    float x = 0.f;
    if (row < rows && d < HD) {
      const long long off =
          ((((long long)lb * L + row / G) * Kv + kvh) * G + row % G) * HD + d;
      x = to_float(q[off]) * scale;
    }
    sq[r * P + d] = x;
  }

  int k_begin, k_end;
  key_range(row0, ROWS, rows, G, L, mode, prompt_len, block_size, window,
            &k_begin, &k_end);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin / kTileK * kTileK; k0 < k_end; k0 += kTileK) {
    __syncthreads();  // the previous tile is consumed (first pass: sq ready)
    for (int idx = tid; idx < kTileK * P; idx += kThreads) {
      const int j = idx / P, d = idx % P, kp = k0 + j;
      float xk = 0.f, xv = 0.f;
      if (kp < L && d < HD) {
        const long long off = (((long long)lb * L + kp) * Kv + kvh) * HD + d;
        xk = to_float(k[off]);
        xv = to_float(v[off]);
      }
      sk[j * (P + 1) + d] = xk;
      sv[j * P + d] = xv;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const int row = row0 + r;
      if (row >= rows) continue;  // warp-uniform
      const int qp = row / G;
      const int kp = k0 + lane;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += sq[r * P + d] * sk[lane * (P + 1) + d];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const bool vis = kp < L && visible(qp, kp, mode, prompt_len,
                                         block_size, window);
      s = vis ? s : -INFINITY;
      const float tile_max = warp_max(s);
      if (tile_max == -INFINITY) continue;  // nothing visible: warp-uniform
      const float m_new = fmaxf(m[i], tile_max);
      const float p = vis ? expf(s - m_new) : 0.f;
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[i][c] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kTileK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          acc[i][c] += pj * sv[j * P + lane + 32 * c];
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + kWarps * i;
    if (row >= rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const long long base =
        ((((long long)lb * L + row / G) * Kv + kvh) * G + row % G) * HD;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      if (lane + 32 * c < HD) out[base + lane + 32 * c] = acc[i][c] * inv;
  }
}

template <typename T, int HD, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int L, int Kv, int G, int mode, int prompt_len,
                   int block_size, int window, float scale, float softcap,
                   cudaStream_t stream) {
  constexpr int smem = f32_smem<HD, ROWS>();
  const cudaError_t err = cudaFuncSetAttribute(
      block_attn_kernel<T, HD, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L * G + ROWS - 1) / ROWS, Kv, b);
  block_attn_kernel<T, HD, ROWS><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), L, Kv, G, mode,
      prompt_len, block_size, window, scale, softcap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------
constexpr int kKeys = 64;  // keys per K/V tile

// Shared memory of block_attn_tc: a ring of K and V tiles (the ring's
// barriers after it), then the block's Q (kRows rows, P / 64 boxes per 64
// rows, P the head_dim padded to a multiple of 64), each 1024-byte
// aligned.
template <int HD>
struct AttnTc {
  static constexpr int kP = padded(HD);
  // warpgroups that share a row group of 64 rows, each owning kP / kSplit
  // columns of O: at head_dim 256 a 64 x 256 fp32 O would take 128
  // registers a thread, so both warpgroups compute the 64 rows' S and keep
  // half of O each, and a block holds 64 rows instead of 128
  static constexpr int kSplit = kP > 128 ? 2 : 1;
  static constexpr int kOCols = kP / kSplit;
  static constexpr int kRows = 64 * 2 / kSplit;          // rows a block
  static constexpr int kBoxes = kP / 64;                 // boxes per tile
  static constexpr int kQBytes = kRows * kP * 2;
  static constexpr int kKvTile = kKeys * kP * 2;         // one K or V tile
  static constexpr int kStage = 2 * kKvTile;
  // three stages and Q fit 227 KB up to head_dim 128; two at 256
  static constexpr int kStages = kP > 128 ? 2 : 3;
  // blocks per SM: two at hd 64 (128 registers a thread), one above
  static constexpr int kBlocksPerSm = HD == 64 ? 2 : 1;
  static constexpr int kSmem = kStages * kStage + kQBytes + 2 * 1024 + 256;
};

// O (+)= P V for one 16-key step: A = P from registers, B = V MN-major.
__device__ __forceinline__ void pv_step(float (&o)[32], const uint32_t (&a)[4],
                                        uint64_t dv) {
  hopper::wgmma_64_rs<1>(o, a, dv, 1);
}
__device__ __forceinline__ void pv_step(float (&o)[64], const uint32_t (&a)[4],
                                        uint64_t dv) {
  hopper::wgmma_128_rs<1>(o, a, dv, 1);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// grid: (ceil(L*G / kRows), Kv, b); block: tc::kConsumers threads, two
// warpgroups: of 64 rows each (kSplit 1), or both of the block's 64 rows,
// each with half of O's columns (kSplit 2). Thread 0 also issues the TMA
// loads of the ring (no producer warp: without it two blocks fit an SM at
// hd 64). q (b, L, Kv, G, HD) bf16 contiguous; kmap / vmap: k and v (b, L,
// Kv, HD) as (b L, Kv HD) matrices, or at a head_dim not a multiple of 64
// as (b L, Kv, HD) 3-D maps whose boxes TMA zero-fills past HD; out (b, L,
// Kv, G, HD) fp32.
template <int HD>
__global__ void __launch_bounds__(tc::kConsumers, AttnTc<HD>::kBlocksPerSm)
block_attn_tc(const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __nv_bfloat16* __restrict__ q, float* __restrict__ out,
              int L, int Kv, int G, int mode, int prompt_len, int block_size,
              int window, float scale, float softcap) {
  using A = AttnTc<HD>;
  extern __shared__ char smem[];
  char* rest;
  const tc::Ring r = tc::ring_init(smem, A::kStages, A::kStage, &rest);
  char* q_all = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(rest) + 1023) & ~uintptr_t(1023));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = L * G;
  const int row0 = blockIdx.x * A::kRows;
  const int kvh = blockIdx.y, lb = blockIdx.z;
  int k_begin, k_end;
  key_range(row0, A::kRows, rows, G, L, mode, prompt_len, block_size,
            window, &k_begin, &k_end);
  const int j0 = k_begin / kKeys, j1 = (k_end + kKeys - 1) / kKeys;
  // thread 0's loads: tile jl into the ring once both warpgroups freed its
  // stage (rows past this lane's L are the next lane's keys or zero fill:
  // masked below)
  const bool loader = threadIdx.x == 0;
  tc::Cursor lc;
  int jl = j0;
  auto load_next = [&]() {
    hopper::bar_wait(&r.empty[lc.stage], lc.phase ^ 1);
    char* st = r.data + lc.stage * A::kStage;
    uint64_t* bar = &r.full[lc.stage];
    hopper::bar_expect_tx(bar, A::kStage);
    const int key = lb * L + jl * kKeys;
#pragma unroll
    for (int x = 0; x < A::kBoxes; ++x) {
      if constexpr (HD % 64 == 0) {
        hopper::tma_load(st + x * hopper::kBoxBytes, &kmap, bar,
                         kvh * HD + 64 * x, key);
        hopper::tma_load(st + A::kKvTile + x * hopper::kBoxBytes, &vmap, bar,
                         kvh * HD + 64 * x, key);
      } else {
        hopper::tma_load_3d(st + x * hopper::kBoxBytes, &kmap, bar, 64 * x,
                            kvh, key);
        hopper::tma_load_3d(st + A::kKvTile + x * hopper::kBoxBytes, &vmap,
                            bar, 64 * x, kvh, key);
      }
    }
    lc.next(A::kStages);
    ++jl;
  };
  if (loader) {
    hopper::prefetch_map(&kmap);
    hopper::prefetch_map(&vmap);
    while (jl < j1 && jl < j0 + A::kStages) load_next();
  }
  __syncwarp();
  tc::Cursor c;
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const int rg = wg / A::kSplit, half = wg % A::kSplit;
  // this row group's 64 query rows, K-major, 128-byte swizzle: 16-byte
  // chunk ch of row rr at rr * 128 + ((ch ^ rr) % 8) * 16 of box ch / 8;
  // zero in the padding past HD. Copied by the row group's warpgroups.
  char* qs = q_all + rg * A::kBoxes * hopper::kBoxBytes;
  constexpr int kChunks = A::kP / 8, kReal = HD / 8;
  constexpr int kGroupThreads = 128 * A::kSplit;
  for (int x = threadIdx.x % kGroupThreads; x < 64 * kChunks;
       x += kGroupThreads) {
    const int rr = x / kChunks, ch = x % kChunks;
    const int row = row0 + 64 * rg + rr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && ch < kReal)
      val = *reinterpret_cast<const uint4*>(
          q + ((((long long)lb * L + row / G) * Kv + kvh) * G + row % G) *
                  HD + 8 * ch);
    *reinterpret_cast<uint4*>(qs + (ch / 8) * hopper::kBoxBytes + rr * 128 +
                              (((ch % 8) ^ (rr & 7)) * 16)) = val;
  }
  hopper::fence_proxy_async();  // st.shared before wgmma reads it
  hopper::named_sync(1 + rg, kGroupThreads);

  int qp[2];  // query position of the thread's two rows
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    qp[hf] = (row0 + 64 * rg + tc::frag_row(hf, warp, lane)) / G;
  const int q_lo = row0 / G;
  const bool capped = softcap > 0.f;
  // base-2 scores: log2 e folds into the scale (after the softcap if any)
  const float s_scale = capped ? scale : scale * tc::kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  constexpr int kO = A::kOCols / 2;   // this warpgroup's O fragment
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;

  for (int j = j0; j < j1; ++j) {
    const int k0 = j * kKeys;
    hopper::bar_wait(&r.full[c.stage], c.phase);
    const char* kt = r.data + c.stage * A::kStage;
    const char* vt = kt + A::kKvTile;
    // S = Q K^T (64 x 64 per warpgroup), both K-major, over the real
    // head_dim (the padding is zero)
    float s[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      hopper::wgmma_64<0, 0>(
          s, hopper::desc_k(qs + (ks / 4) * hopper::kBoxBytes, ks % 4),
          hopper::desc_k(kt + (ks / 4) * hopper::kBoxBytes, ks % 4), ks > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(s);
    // every row of the block sees every key of the tile: no per-key test
    // (visibility is monotone in the query position without a window)
    const int k_last = k0 + kKeys - 1;
    const bool all_visible =
        k_last < L && window <= 0 &&
        (mode == kBidirectional ||
         (mode == kCausal ? k_last <= q_lo
                          : cdlm_block(k_last, prompt_len, block_size) <=
                                cdlm_block(q_lo, prompt_len, block_size)));
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int i = (jj / 2) * 4 + hf * 2 + (jj & 1);
        float t = s[i] * s_scale;
        if (capped) t = softcap * tanhf(t / softcap) * tc::kLog2e;
        if (!all_visible) {
          const int kp = k0 + tc::frag_col(i, lane);
          if (!(kp < L && visible(qp[hf], kp, mode, prompt_len, block_size,
                                  window)))
            t = -INFINITY;
        }
        s[i] = t;
        mx = fmaxf(mx, t);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      // a row that has seen no key yet keeps p = 0 (2^-inf) and alpha = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[hf] = hopper::exp2_approx(m[hf] - m_use);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int i = (jj / 2) * 4 + hf * 2 + (jj & 1);
        s[i] = hopper::exp2_approx(s[i] - m_use);
        ps += s[i];
      }
      l[hf] = l[hf] * alpha[hf] + ps;  // this thread's columns; quad-summed
      m[hf] = m_new;                   // at the end
    }
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] *= alpha[(i / 2) & 1];
    // P as the bf16 pair, in the A fragment of each 16-key step
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = s[8 * ks + 2 * e], x1 = s[8 * ks + 2 * e + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
        hi[ks][e] = bits(h2);
        lo[ks][e] = bits(__floats2bfloat162_rn(x0 - __low2float(h2),
                                               x1 - __high2float(h2)));
      }
    // this warpgroup's O columns: V's boxes from half kOCols / 64
    const char* vh = vt + half * (A::kOCols / 64) * hopper::kBoxBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t dv = hopper::desc_mn(vh, ks);
      pv_step(o, hi[ks], dv);
      pv_step(o, lo[ks], dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(o);
    if (tid == 0) hopper::bar_arrive(&r.empty[c.stage]);
    c.next(A::kStages);
    // the stage just freed (by both warpgroups) takes tile j + kStages
    if (loader && jl < j1) load_next();
    __syncwarp();
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int row = row0 + 64 * rg + tc::frag_row(hf, warp, lane);
    if (row >= rows) continue;
    float* orow =
        out + ((((long long)lb * L + row / G) * Kv + kvh) * G + row % G) * HD;
#pragma unroll
    for (int qq = 0; qq < kO / 4; ++qq) {
      const int i = 4 * qq + 2 * hf;
      const int col = half * A::kOCols + tc::frag_col(i, lane);
      if (col < HD)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[i] * inv, o[i + 1] * inv);
    }
  }
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int b, int L, int Kv, int G, int mode, int prompt_len,
                      int block_size, int window, float scale, float softcap,
                      cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  const bool ok =
      HD % 64 == 0
          ? hopper::make_map(&kmap, k, b * L, Kv * HD, Kv * HD) &&
                hopper::make_map(&vmap, v, b * L, Kv * HD, Kv * HD)
          : hopper::make_map_heads(&kmap, k, b * L, Kv, HD) &&
                hopper::make_map_heads(&vmap, v, b * L, Kv, HD);
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      block_attn_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      AttnTc<HD>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L * G + AttnTc<HD>::kRows - 1) / AttnTc<HD>::kRows, Kv,
                  b);
  block_attn_tc<HD><<<grid, tc::kConsumers, AttnTc<HD>::kSmem, stream>>>(
      kmap, vmap, static_cast<const __nv_bfloat16*>(q),
      static_cast<float*>(out), L, Kv, G, mode, prompt_len, block_size,
      window, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

// q (b, L, Kv, G, hd) and k/v (b, L, Kv, hd) contiguous, one dtype (bf16:
// 16-byte aligned); out (b, L, Kv, G, hd) fp32. mode: 0 bidirectional, 1
// causal, 2 block_causal; block_size > 0; softcap <= 0 and window <= 0 mean
// none. bf16 runs on the tensor cores, fp32 on CUDA cores. Launches on
// `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for a head_dim other than 64, 112, 128 or 256, or
// a TMA tensor map the driver refuses).
extern "C" int block_attn_forward(const void* q, const void* k,
                                  const void* v, void* out, int b, int L,
                                  int Kv, int G, int hd, int mode,
                                  int prompt_len, int block_size, int window,
                                  float scale, float softcap, int is_bf16,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd == 64)
      return launch_tc<64>(q, k, v, out, b, L, Kv, G, mode, prompt_len,
                           block_size, window, scale, softcap, s);
    if (hd == 112)
      return launch_tc<112>(q, k, v, out, b, L, Kv, G, mode, prompt_len,
                            block_size, window, scale, softcap, s);
    if (hd == 128)
      return launch_tc<128>(q, k, v, out, b, L, Kv, G, mode, prompt_len,
                            block_size, window, scale, softcap, s);
    if (hd == 256)
      return launch_tc<256>(q, k, v, out, b, L, Kv, G, mode, prompt_len,
                            block_size, window, scale, softcap, s);
    return cudaErrorInvalidValue;
  }
  // shared memory (f32_smem): 33 KB at head_dim 64, 41 KB at 128, 37 KB at
  // 112 (8 rows a block, one a warp: with 16, ptxas kept the instance at 48
  // registers and spilled), 82 KB at 256 (the opt-in above 48 KB)
  if (hd == 64)
    return launch<float, 64, 64>(q, k, v, out, b, L, Kv, G, mode, prompt_len,
                                 block_size, window, scale, softcap, s);
  if (hd == 112)
    return launch<float, 112, 8>(q, k, v, out, b, L, Kv, G, mode, prompt_len,
                                 block_size, window, scale, softcap, s);
  if (hd == 128)
    return launch<float, 128, 16>(q, k, v, out, b, L, Kv, G, mode,
                                  prompt_len, block_size, window, scale,
                                  softcap, s);
  if (hd == 256)
    return launch<float, 256, 16>(q, k, v, out, b, L, Kv, G, mode,
                                  prompt_len, block_size, window, scale,
                                  softcap, s);
  return cudaErrorInvalidValue;
}
