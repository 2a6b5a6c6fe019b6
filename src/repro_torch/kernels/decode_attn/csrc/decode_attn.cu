// Decode attention of the CDLM active block, for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/decode_attn/decode_attn.py::
// decode_attention_partial (body _decode_kernel) and
// paged_decode_attention_partial (body _paged_decode_kernel), together
// with the work their wrappers in ops.py do around them in jnp
// (_block_partial, the in-block part, and softmax_combine, the merge): here
// the cache rows below each lane's cache_len and then the block's own fresh
// keys run through one fp32 online softmax, and the output is normalized.
//
// What it computes, per lane and KV head: the folded query rows (row =
// qpos * G + g, so the G query heads that share a KV head share every K/V
// tile) attend to the cache keys kp < cache_lens[lane], with a window
// (cache_len + row / G) - kp < window, then to the block's Bq fresh keys,
// with a window |row / G - kp| < window. Softcap comes before the mask; the
// output is normalized by max(l, 1e-30) and written (b, Bq, Kv, G, hd) fp32.
// The cache is read in its model layout (b, S, Kv, hd) through strides (a
// period slice of the stacked cache), so no per-call copy is made.
//
// The paged variant (PAGED = true) reads a pool (n_pages, page, Kv, hd)
// shared by the lanes: key kp of lane lb is row kp % page of pool page
// page_table[lb, kp / page]. That address is the only difference from the
// dense kernel: the keys run in the same tiles, the same splits and the same
// order through the same arithmetic, so on an identity table (and on a
// shuffled one with the same contents) the two give the same bits, for any
// page size. Nothing at or past cache_len is read, and a FREE (-1) entry is
// never dereferenced (its keys are invisible, as the TPU kernel skips such
// pages): pool pages are not zeroed when freed, and their residue, NaN
// included, never reaches the output.
//
// What bounds it on this card: very little work per call. At the main
// path's shape (qwen2-0.5b: 8 lanes, a 32-token block, 2 KV heads of 7
// query heads, head_dim 64, caches of 512-736 rows, bf16) one call reads
// about 3.5 MB, about 1 us at 3.35 TB/s, and does about 0.5 GFLOP, under
// 1 us on the tensor cores. Its time is latency and parallelism: there are
// only b * Kv = 16 (lane, KV head) pairs, and each walks about 12 key tiles
// one after another. The design, by dtype:
//
//  - bf16 (decode_attn_tc, the model's path): tensor cores. A block owns one
//    split of one (lane, KV head, row tile): up to 4 warpgroups of 64 folded
//    rows at head_dim 64 (224 rows, all of a lane's, in one block of 512
//    threads at <= 128 registers, so every K/V tile is read once per pair), 2
//    at head_dim 128 (whose 64-column O accumulator takes ~160 registers: 224
//    rows make 2 row tiles of 2 x 64), and only as many as the rows need
//    (llada-8b, G = 1: 32 rows, one warpgroup). The block copies its Q rows
//    once, 16 bytes a copy, into the 128-byte-swizzled K-major layout (the
//    folded rows are not a strided matrix at G = 7, so no TMA box fits), zero
//    past Bq * G. A lane's keys form logical 64-key tiles: ceil(cache_len / 64)
//    cache tiles, then ceil(Bq / 64) tiles of fresh keys; a split walks a fixed
//    number T of them (ref.py::tiles_per_split: from Kv and the rows only, 2 at
//    qwen2-0.5b, so 7 splits x 16 pairs = 112 blocks fill the card), and the
//    host sizes the grid from S, so no host reads cache_lens; a block whose
//    split has no tile of its lane exits at once. All threads stream K and V
//    tiles with 16-byte cp.async into 2 stages, one row per key (the paged
//    address is per row, and pages of 32, 16, 7 or 5 rows fit no TMA box; a
//    paged block reads the split's pool rows from the table once, into shared
//    memory, before its first copy), K and V in the same swizzled layout (K
//    read K-major for S = Q K^T, V MN-major for O += P V). A key at or past its
//    limit (cache_len, Bq) or on a -1 page is not read: cp.async zero-fills its
//    row, so p = 0 meets v = 0, never NaN. Per tile: S by wgmma (head_dim / 16
//    k-steps, fp32), scale in fp32 after the product with log2 e folded in,
//    softcap, the visibility mask in registers (skipped, with the scale folded
//    into the exponent, on a tile every row sees whole), a base-2 online
//    softmax with each row's statistics in its quad, then O += P V in the RS
//    form with P as the bf16 pair p_hi = bf16(p), p_lo = bf16(p - p_hi) (one
//    rounding of p is ~1e-3 of the output, the pair leaves 2^-18). A lane whose
//    keys fit one split is normalized and written by its one block. Otherwise
//    each split writes its unnormalized (acc, m, l) partials to scratch, and
//    decode_merge_kernel, launched after it in the same call, merges each row's
//    splits in split order (softmax_combine, base 2) and normalizes: one warp a
//    row over the whole card (merging in the last block of each lane instead,
//    after an atomic ticket, leaves 16 blocks to read all the partials, and
//    was slower). No atomics: two calls give the same bits.
//  - fp32 (decode_attn_kernel): CUDA cores in fp32 (the tensor cores' fp32
//    is TF32), one block per (lane, KV head, tile of rows): one warp owns a
//    query row at a time, lane j scores key j of a 32-key tile, the warp
//    reduces max and sum with shuffles, each lane keeps hd / 32 output
//    columns in registers.
//
// Head dims 64, 112, 128 and 256 (qwen2-0.5b, kimi-k2, dream-7b / llada-8b /
// gemma2 / llama4, gemma-7b). Two of them do not fit the layouts above as
// they are:
//  - 112 is not a multiple of the 64-value swizzle box. Rows are padded to
//    128 in shared memory and registers: the 16-byte copies of columns 112
//    .. 127 read nothing and zero-fill, S runs 7 k-steps of 16 over the real
//    columns, P V runs at N = 128 and columns past 112 are never written.
//    The scale is the caller's (1/sqrt(112)), never the padded width's.
//  - 256 would need a 64 x 256 fp32 O accumulator, 128 registers a thread
//    on top of S. Two warpgroups share each group of 64 rows instead: both
//    compute the same S (16 k-steps) and softmax statistics, and each keeps
//    and writes one 128-column half of O (its P V reads V's boxes from its
//    half), so a thread holds the registers of the head_dim 128 kernel; the
//    block holds one row group (256 threads), and a K and a V tile take 32
//    KB each (two stages and Q: 165 KB of shared memory).
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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Head dims not a multiple of 64 (kimi-k2's 112) run padded to the next
// multiple of 64 in shared memory and registers: the padding columns are
// zero, every global offset uses the real head_dim, and nothing past it is
// written.
__host__ __device__ constexpr int padded(int hd) {
  return (hd + 63) / 64 * 64;
}

// Dynamic shared memory of decode_attn_kernel: Q (ROWS x P), K (32 x P+1),
// V (32 x P) in fp32 and a byte per key, P = padded(HD); over 48 KB at
// head_dim 256, so it is opted into at launch.
template <int HD, int ROWS>
constexpr int f32_smem() {
  return (ROWS * padded(HD) + kTileK * (padded(HD) + 1) +
          kTileK * padded(HD)) * 4 + kTileK;
}

// grid: (ceil(Bq*G / ROWS), Kv, b); block: kThreads. Loads and stores use
// HD; the products run over P = padded(HD), whose padding is zero. Dense:
// the cache is (b, S, Kv, hd) with strides (c_sb, c_ss, c_sk, 1). Paged:
// the pool is (n_pages, page, Kv, hd) with strides (c_sb, c_ss, c_sk, 1),
// page_table is (b, n_t) int32 and S = n_t * page.
template <int HD, int ROWS, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const float* __restrict__ q,
                   const float* __restrict__ kc, const float* __restrict__ vc,
                   const float* __restrict__ kb, const float* __restrict__ vb,
                   const int* __restrict__ cache_lens,
                   const int* __restrict__ page_table,
                   float* __restrict__ out, int Bq, int Kv, int G, int S,
                   int n_t, int page, long long c_sb, long long c_ss,
                   long long c_sk, float scale, float softcap, int window) {
  constexpr int P = padded(HD);
  constexpr int kRowsPerWarp = ROWS / kWarps;
  constexpr int kColsPerLane = P / 32;
  extern __shared__ float f32_raw[];
  float* sq = f32_raw;                  // [ROWS][P]
  float* sk = sq + ROWS * P;            // [kTileK][P + 1]: lane j reads row
  float* sv = sk + kTileK * (P + 1);    // j conflict-free; [kTileK][P]
  bool* s_ok = reinterpret_cast<bool*>(sv + kTileK * P);  // paged: the
                                        // key's page is allocated

  const int rows = Bq * G;
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
          ((((long long)lb * Bq + row / G) * Kv + kvh) * G + row % G) * HD + d;
      x = q[off] * scale;
    }
    sq[r * P + d] = x;
  }
  const int clen = min(max(cache_lens[lb], 0), S);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) acc[i][c] = 0.f;
  }

  const int cache_tiles = (clen + kTileK - 1) / kTileK;
  const int tiles = cache_tiles + (Bq + kTileK - 1) / kTileK;
  for (int t = 0; t < tiles; ++t) {
    const bool in_cache = t < cache_tiles;
    const int k0 = (in_cache ? t : t - cache_tiles) * kTileK;
    const int klimit = in_cache ? clen : Bq;
    __syncthreads();  // the previous tile is consumed (first pass: sq ready)
    for (int idx = tid; idx < kTileK * P; idx += kThreads) {
      const int j = idx / P, d = idx % P, kp = k0 + j;
      float xk = 0.f, xv = 0.f;
      if (kp < klimit && d < HD) {
        if (in_cache) {
          long long off;
          bool ok = true;
          if constexpr (PAGED) {
            const int pid = page_table[(long long)lb * n_t + kp / page];
            ok = pid >= 0;
            off = pid * c_sb + (kp % page) * c_ss + kvh * c_sk + d;
            if (d == 0) s_ok[j] = ok;
          } else {
            off = lb * c_sb + kp * c_ss + kvh * c_sk + d;
          }
          if (ok) {
            xk = kc[off];
            xv = vc[off];
          }
        } else {
          const long long off = (((long long)lb * Bq + kp) * Kv + kvh) * HD + d;
          xk = kb[off];
          xv = vb[off];
        }
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
      const int qrel = row / G;
      const int kp = k0 + lane;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += sq[r * P + d] * sk[lane * (P + 1) + d];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool vis = kp < klimit;
      if constexpr (PAGED) vis = vis && (!in_cache || s_ok[lane]);
      if (window > 0)
        vis = vis && (in_cache ? (clen + qrel) - kp < window
                               : abs(qrel - kp) < window);
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
        ((((long long)lb * Bq + row / G) * Kv + kvh) * G + row % G) * HD;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      if (lane + 32 * c < HD) out[base + lane + 32 * c] = acc[i][c] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (wgmma) fed by cp.async
// ---------------------------------------------------------------------------
constexpr int kKeys = 64;   // keys per K/V tile (ref.py KEY_TILE)
constexpr int kStages = 2;  // K/V tiles in flight
constexpr int kMaxT = 8;    // tiles per split at most (ref.tiles_per_split)
constexpr int kMergeWarps = 8;

// Shared memory of decode_attn_tc, 1024-byte aligned: kStages stages of a
// K tile and a V tile (each P / 64 boxes of 64 keys x 64 values, P the
// head_dim padded to a multiple of 64), then the block's Q (a row group's
// P / 64 boxes of 64 rows per row group), then
// the pool row of each of the split's cache keys (paged), per stage the last
// tile it held with a key on a -1 page below its limit, then one byte per
// key and stage: the key may be seen (below its limit, on an allocated
// page).
template <int HD>
struct DecTc {
  static constexpr int kP = padded(HD);
  // warpgroups that share a row group, each owning kP / kSplit columns of
  // O: at head_dim 256 a whole 64 x 256 fp32 O would take 128 registers a
  // thread, so two warpgroups each compute the row group's S and keep half
  static constexpr int kSplit = kP > 128 ? 2 : 1;
  static constexpr int kOCols = kP / kSplit;          // O columns a warpgroup
  static constexpr int kTileBytes = kKeys * kP * 2;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kWgQBytes = 64 * kP * 2;       // one row group's Q
  // warpgroups a block may hold: 4 x 128 threads at <= 128 registers at
  // head_dim 64; a 64 x 128 O accumulator needs more, so 2
  static constexpr int kMaxWg = HD == 64 ? 4 : 2;
  static constexpr int smem(int nrg) {
    return 1024 + kStages * kStageBytes + nrg * kWgQBytes +
           kMaxT * kKeys * 8 + kStages * 4 + kStages * kKeys;
  }
};

struct TcArgs {
  const __nv_bfloat16 *q, *kc, *vc, *kb, *vb;
  const int *cache_lens, *page_table;
  float *part_acc, *part_ml, *out;
  int Bq, Kv, G, S, n_t, page;
  int T;          // 64-key tiles per split
  int nwg;        // warpgroups per block (kSplit per row group of 64 rows)
  int vec;        // every row 16-byte aligned: cp.async, else 2-byte loads
  long long c_sb, c_ss, c_sk;
  float scale, softcap;
  int window;
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Eight bf16 values at `src`, with 2-byte loads (rows not 16-byte aligned).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src) {
  union {
    __nv_bfloat16 h[8];
    uint4 v;
  } u;
#pragma unroll
  for (int e = 0; e < 8; ++e) u.h[e] = src[e];
  return u.v;
}

// O (+)= P V for one 16-key step: A = P from registers, B = V MN-major.
__device__ __forceinline__ void pv_step(float (&o)[32], const uint32_t (&a)[4],
                                        uint64_t dv) {
  hopper::wgmma_64_rs<1>(o, a, dv, 1);
}
__device__ __forceinline__ void pv_step(float (&o)[64], const uint32_t (&a)[4],
                                        uint64_t dv) {
  hopper::wgmma_128_rs<1>(o, a, dv, 1);
}

// grid: (Kv * row tiles, splits, b); block: 128 * a.nwg threads, a.nwg /
// kSplit row groups of 64 rows (warpgroup w: row group w / kSplit, O
// columns (w % kSplit) kOCols ..). Split
// blockIdx.y walks the lane's logical key tiles [y T, y T + T) (cache tiles
// first, then the fresh keys) for the rows of row tile blockIdx.x / Kv, and
// writes their output (a lane with one split) or their partials: acc
// (splits, b, Kv, Bq G, HD) and (m, l) (splits, b, Kv, Bq G, 2),
// unnormalized, m in base 2. The KV head varies fastest
// across the grid, so blocks that run together read all heads of the same
// key rows. Dense: the cache is (b, S, Kv, HD) with strides (c_sb, c_ss,
// c_sk, 1); paged: the pool is (n_pages, page, Kv, HD) with those strides,
// page_table (b, n_t), S = n_t page.
template <int HD, bool PAGED>
__global__ void __launch_bounds__(DecTc<HD>::kMaxWg * 128, 1)
decode_attn_tc(const TcArgs a) {
  using D = DecTc<HD>;
  extern __shared__ char smem_raw[];
  char* stages = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* q_all = stages + kStages * D::kStageBytes;
  const int nrg = a.nwg / D::kSplit;  // row groups
  // paged: the pool row of each cache key of the split (element offset,
  // -1 on a -1 page)
  long long* row_off =
      reinterpret_cast<long long*>(q_all + nrg * D::kWgQBytes);
  // per stage, the last tile loaded there that had a key on a -1 page
  int* hole_at = reinterpret_cast<int*>(row_off + kMaxT * kKeys);
  unsigned char* ok_key = reinterpret_cast<unsigned char*>(hole_at + kStages);

  const int kvh = blockIdx.x % a.Kv, rt = blockIdx.x / a.Kv;
  const int split = blockIdx.y, lb = blockIdx.z;
  const int rows = a.Bq * a.G;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int rg = wg / D::kSplit, half = wg % D::kSplit;
  constexpr int kChunks = D::kP / 8;  // 16-byte chunks of a padded row
  constexpr int kReal = HD / 8;       // of them, those that hold values
  // the thread's chunk of every row it copies (nthr is a multiple of
  // kChunks, so it is the same in every row)
  const int ch = tid % kChunks;
  constexpr int kGroupThreads = 128 * D::kSplit;

  // this row group's 64 query rows, K-major, 128-byte swizzle, zero past
  // the lane's rows and in the padding; copied by the row group's
  // warpgroups, they start before cache_len is read and join tile t0's
  // cp.async group
  const int wrow0 = (rt * nrg + rg) * 64;
  const bool active = wrow0 < rows;  // warpgroup-uniform
  char* qs = q_all + rg * D::kWgQBytes;
  for (int rr = (tid % kGroupThreads) / kChunks; rr < 64;
       rr += kGroupThreads / kChunks) {
    const int row = wrow0 + rr;
    const bool real = row < rows && ch < kReal;
    const __nv_bfloat16* src =
        real ? a.q + ((((long long)lb * a.Bq + row / a.G) * a.Kv + kvh) *
                          a.G + row % a.G) * HD + 8 * ch
             : a.q;
    char* dst = qs + (ch / 8) * hopper::kBoxBytes + rr * 128 +
                (((ch % 8) ^ (rr & 7)) * 16);
    if (a.vec)
      hopper::cp_async_16(dst, src, real ? 16 : 0);
    else
      *reinterpret_cast<uint4*>(dst) =
          real ? load8(src) : make_uint4(0u, 0u, 0u, 0u);
  }

  const int clen = min(max(a.cache_lens[lb], 0), a.S);
  const int nc = (clen + kKeys - 1) / kKeys;    // cache tiles
  const int n_tiles = nc + (a.Bq + kKeys - 1) / kKeys;
  const int t0 = split * a.T;
  const int t1 = min(t0 + a.T, n_tiles);
  if (t0 >= t1) {  // no tile of this lane: not one of its `used` splits
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    return;
  }
  if (tid < kStages) hole_at[tid] = -1;
  if constexpr (PAGED) {
    for (int i = tid; i < (t1 - t0) * kKeys; i += nthr) {
      const int t = t0 + i / kKeys, kp = t * kKeys + i % kKeys;
      long long off = -1;
      if (t < nc && kp < clen) {
        const int pid = a.page_table[(long long)lb * a.n_t + kp / a.page];
        if (pid >= 0)
          off = pid * a.c_sb + (long long)(kp % a.page) * a.c_ss;
      }
      row_off[i] = off;
    }
  }
  __syncthreads();
  // The thread's share of logical tile t's K and V rows into stage st, in
  // the swizzled layout: chunk ch of key row j at box ch / 8, j * 128 +
  // ((ch % 8) ^ (j % 8)) * 16. A key past its limit or on a -1 page is not
  // read, and its row is zero, as is the padding past head_dim.
  auto load_tile = [&](int t, int st) {
    char* kt = stages + st * D::kStageBytes;
    char* vt = kt + D::kTileBytes;
    const bool in_cache = t < nc;
    const int k0 = (in_cache ? t : t - nc) * kKeys;
    const int limit = in_cache ? clen : a.Bq;
    for (int j = tid / kChunks; j < kKeys; j += nthr / kChunks) {
      const int kp = k0 + j;
      const __nv_bfloat16 *ks = a.kb, *vs = a.vb;  // read nothing if !ok
      long long off = 0;
      bool ok = kp < limit;
      if (ok && in_cache) {
        ks = a.kc;
        vs = a.vc;
        if constexpr (PAGED) {
          const long long ro = row_off[(t - t0) * kKeys + j];
          ok = ro >= 0;
          off = ro + kvh * a.c_sk;
        } else {
          off = lb * a.c_sb + kp * a.c_ss + kvh * a.c_sk;
        }
      } else if (ok) {
        off = (((long long)lb * a.Bq + kp) * a.Kv + kvh) * HD;
      }
      if (!ok) off = 0;
      if (ch == 0) {
        ok_key[st * kKeys + j] = ok;
        if (!ok && kp < limit) hole_at[st] = t;  // a -1 page below the limit
      }
      const int so = (ch / 8) * hopper::kBoxBytes + j * 128 +
                     (((ch % 8) ^ (j & 7)) * 16);
      const bool rd = ok && ch < kReal;
      const int co = rd ? 8 * ch : 0;
      if (a.vec) {
        hopper::cp_async_16(kt + so, ks + off + co, rd ? 16 : 0);
        hopper::cp_async_16(vt + so, vs + off + co, rd ? 16 : 0);
      } else {
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(kt + so) = rd ? load8(ks + off + co)
                                                : zero;
        *reinterpret_cast<uint4*>(vt + so) = rd ? load8(vs + off + co)
                                                : zero;
      }
    }
  };

  load_tile(t0, 0);
  hopper::cp_async_commit();
  if (t0 + 1 < t1) load_tile(t0 + 1, 1);
  hopper::cp_async_commit();

  int qrel[2];  // query position in the block of the thread's two rows
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    qrel[hf] = (wrow0 + tc::frag_row(hf, warp, lane)) / a.G;
  const bool capped = a.softcap > 0.f;
  // base-2 scores: log2 e folds into the scale (after the softcap if any)
  const float s_scale = capped ? a.scale : a.scale * tc::kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  constexpr int kO = D::kOCols / 2;   // this warpgroup's O fragment
  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) % kStages;
    hopper::cp_async_wait<1>();    // this thread's rows of tile t landed
    hopper::fence_proxy_async();   // its shared writes before wgmma reads
    __syncthreads();
    if (active) {
      const char* kt = stages + st * D::kStageBytes;
      const char* vt = kt + D::kTileBytes;
      // S = Q K^T (64 x 64 per warpgroup), both K-major, over the real
      // head_dim (the padding is zero)
      float s[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        hopper::wgmma_64<0, 0>(
            s, hopper::desc_k(qs + (ks / 4) * hopper::kBoxBytes, ks % 4),
            hopper::desc_k(kt + (ks / 4) * hopper::kBoxBytes, ks % 4),
            ks > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(s);
      const bool in_cache = t < nc;
      const int k0 = (in_cache ? t : t - nc) * kKeys;
      const int limit = in_cache ? clen : a.Bq;
      // every key of the tile visible to every row: no per-key test, and
      // the scale folds into the exponent's fma
      const bool plain = !capped && a.window <= 0 && a.scale > 0.f &&
                         k0 + kKeys <= limit &&
                         !(PAGED && in_cache && hole_at[st] == t);
      float alpha[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = -INFINITY;
        if (plain) {
#pragma unroll
          for (int jj = 0; jj < 16; ++jj)
            mx = fmaxf(mx, s[(jj / 2) * 4 + hf * 2 + (jj & 1)]);
        } else {
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) {
            const int i = (jj / 2) * 4 + hf * 2 + (jj & 1);
            const int col = tc::frag_col(i, lane), kp = k0 + col;
            float x = s[i] * s_scale;
            if (capped) x = a.softcap * tanhf(x / a.softcap) * tc::kLog2e;
            bool vis = kp < limit;
            if (PAGED && in_cache) vis = vis && ok_key[st * kKeys + col];
            if (a.window > 0)
              vis = vis && (in_cache ? (clen + qrel[hf]) - kp < a.window
                                     : abs(qrel[hf] - kp) < a.window);
            s[i] = vis ? x : -INFINITY;
            mx = fmaxf(mx, s[i]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (plain) mx *= s_scale;  // the scale is positive
        const float m_new = fmaxf(m[hf], mx);
        // a row that has seen no key yet keeps p = 0 (2^-inf), alpha = 0
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[hf] = hopper::exp2_approx(m[hf] - m_use);
        float ps = 0.f;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int i = (jj / 2) * 4 + hf * 2 + (jj & 1);
          s[i] = hopper::exp2_approx(plain ? fmaf(s[i], s_scale, -m_use)
                                           : s[i] - m_use);
          ps += s[i];
        }
        l[hf] = l[hf] * alpha[hf] + ps;  // this thread's columns; quad-
        m[hf] = m_new;                   // summed at the end
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
      const char* vh = vt + half * (D::kOCols / 64) * hopper::kBoxBytes;
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
    }
    __syncthreads();  // every warpgroup is done with stage st
    if (t + kStages < t1) load_tile(t + kStages, st);
    hopper::cp_async_commit();
  }

  // A lane whose keys fit one split: this block holds the whole softmax,
  // and writes the normalized output itself (the merge skips the lane).
  const int used = (n_tiles + a.T - 1) / a.T;  // splits holding a tile
  const long long out_row0 = ((long long)lb * a.Bq * a.Kv + kvh) * a.G;
  if (used == 1) {
    if (active) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float lt = l[hf];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float inv = 1.f / fmaxf(lt, 1e-30f);
        const int row = wrow0 + tc::frag_row(hf, warp, lane);
        if (row >= rows) continue;
        float* orow = a.out + (out_row0 + (long long)(row / a.G) * a.Kv *
                               a.G + row % a.G) * HD;
#pragma unroll
        for (int qq = 0; qq < kO / 4; ++qq) {
          const int i = 4 * qq + 2 * hf;
          const int col = half * D::kOCols + tc::frag_col(i, lane);
          if (col < HD)
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(o[i] * inv, o[i + 1] * inv);
        }
      }
    }
    return;
  }
  // Otherwise the split's partials go to scratch, for decode_merge_kernel.
  const long long r0 =
      (((long long)split * gridDim.z + lb) * a.Kv + kvh) * rows;
  if (!active) return;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lt = l[hf];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = wrow0 + tc::frag_row(hf, warp, lane);
    if (row >= rows) continue;
    float* arow = a.part_acc + (r0 + row) * HD;
#pragma unroll
    for (int qq = 0; qq < kO / 4; ++qq) {
      const int i = 4 * qq + 2 * hf;
      const int col = half * D::kOCols + tc::frag_col(i, lane);
      if (col < HD)
        *reinterpret_cast<float2*>(arow + col) = make_float2(o[i], o[i + 1]);
    }
    if ((lane & 3) == 0 && half == 0)
      *reinterpret_cast<float2*>(a.part_ml + 2 * (r0 + row)) =
          make_float2(m[hf], lt);
  }
}

// grid: (ceil(Bq G / kMergeWarps), Kv, b); block: kMergeWarps warps, one
// folded row each. For a lane with more than one split holding a tile,
// merges the row's partials of those splits in split order
// (softmax_combine in base 2: weights 2^(m_s - max m); a split whose m is
// -inf has acc = 0 and l = 0 and weighs 0) and writes acc / max(l, 1e-30)
// to out (b, Bq, Kv, G, HD). The loads of a pass do not wait on each other.
template <int HD>
__global__ void __launch_bounds__(kMergeWarps * 32)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    const int* __restrict__ cache_lens,
                    float* __restrict__ out, int Bq, int Kv, int G, int S,
                    int T) {
  constexpr int kCols = (HD + 31) / 32;  // per lane; the last lanes may
                                         // hold fewer (head_dim 112)
  const int rows = Bq * G;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kvh = blockIdx.y, lb = blockIdx.z, b = gridDim.z;
  if (row >= rows) return;
  const int clen = min(max(cache_lens[lb], 0), S);
  const int n_tiles = (clen + kKeys - 1) / kKeys + (Bq + kKeys - 1) / kKeys;
  const int used = (n_tiles + T - 1) / T;
  if (used == 1) return;  // written by the lane's one block
  const long long stride = (long long)b * Kv * rows;  // one split's rows
  const long long r0 = ((long long)lb * Kv + kvh) * rows + row;
  float mx = -INFINITY;
#pragma unroll 4
  for (int s = 0; s < used; ++s)
    mx = fmaxf(mx, part_ml[2 * (r0 + s * stride)]);
  const float m_safe = mx == -INFINITY ? 0.f : mx;
  float acc[kCols], l = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int s = 0; s < used; ++s) {
    const long long r = r0 + s * stride;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * r);
    const float w = ml.x == -INFINITY ? 0.f : exp2f(ml.x - m_safe);
    l += ml.y * w;
    const float* src = part_acc + r * HD + kCols * lane;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (kCols * lane + c < HD) acc[c] += src[c] * w;
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* dst = out + ((((long long)lb * Bq + row / G) * Kv + kvh) * G +
                      row % G) * HD + kCols * lane;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (kCols * lane + c < HD) dst[c] = acc[c] * inv;
}

struct Args {
  const void *q, *kc, *vc, *kb, *vb, *cache_lens, *page_table;
  void *out, *scratch;
  int b, Bq, Kv, G, S, n_t, page, T, n_splits;
  long long c_sb, c_ss, c_sk;
  float scale, softcap;
  int window;
};

template <int HD, int ROWS, bool PAGED>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  constexpr int smem = f32_smem<HD, ROWS>();
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<HD, ROWS, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Bq * a.G + ROWS - 1) / ROWS, a.Kv, a.b);
  decode_attn_kernel<HD, ROWS, PAGED><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kc),
      static_cast<const float*>(a.vc), static_cast<const float*>(a.kb),
      static_cast<const float*>(a.vb), static_cast<const int*>(a.cache_lens),
      static_cast<const int*>(a.page_table), static_cast<float*>(a.out),
      a.Bq, a.Kv, a.G, a.S, a.n_t, a.page, a.c_sb, a.c_ss, a.c_sk, a.scale,
      a.softcap, a.window);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The split kernel, then the merge, on `stream`. Scratch: a.n_splits * b *
// Kv * Bq G * (HD + 2) floats, acc first.
template <int HD, bool PAGED>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  using D = DecTc<HD>;
  const int rows = a.Bq * a.G;
  const int wg_tiles = (rows + 63) / 64;   // row groups of 64 rows
  constexpr int kMaxRg = D::kMaxWg / D::kSplit;
  const int nrg = wg_tiles < kMaxRg ? wg_tiles : kMaxRg;
  const int nwg = nrg * D::kSplit;
  const int row_tiles = (wg_tiles + nrg - 1) / nrg;
  float* part_acc = static_cast<float*>(a.scratch);
  TcArgs t;
  t.q = static_cast<const __nv_bfloat16*>(a.q);
  t.kc = static_cast<const __nv_bfloat16*>(a.kc);
  t.vc = static_cast<const __nv_bfloat16*>(a.vc);
  t.kb = static_cast<const __nv_bfloat16*>(a.kb);
  t.vb = static_cast<const __nv_bfloat16*>(a.vb);
  t.cache_lens = static_cast<const int*>(a.cache_lens);
  t.page_table = static_cast<const int*>(a.page_table);
  t.part_acc = part_acc;
  t.part_ml = part_acc + (long long)a.n_splits * a.b * a.Kv * rows * HD;
  t.out = static_cast<float*>(a.out);
  t.Bq = a.Bq;
  t.Kv = a.Kv;
  t.G = a.G;
  t.S = a.S;
  t.n_t = a.n_t;
  t.page = a.page;
  t.T = a.T;
  t.nwg = nwg;
  // rows of q, the cache and the block k/v all start 16-byte aligned
  t.vec = aligned16(a.q) && aligned16(a.kc) && aligned16(a.vc) &&
          aligned16(a.kb) && aligned16(a.vb) && a.c_sb % 8 == 0 &&
          a.c_ss % 8 == 0 && a.c_sk % 8 == 0;
  t.c_sb = a.c_sb;
  t.c_ss = a.c_ss;
  t.c_sk = a.c_sk;
  t.scale = a.scale;
  t.softcap = a.softcap;
  t.window = a.window;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_tc<HD, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      D::smem(kMaxRg));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Kv * row_tiles, a.n_splits, a.b);
  decode_attn_tc<HD, PAGED><<<grid, 128 * nwg, D::smem(nrg), stream>>>(t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 mgrid((rows + kMergeWarps - 1) / kMergeWarps, a.Kv, a.b);
  decode_merge_kernel<HD><<<mgrid, kMergeWarps * 32, 0, stream>>>(
      part_acc, t.part_ml, t.cache_lens, t.out, a.Bq, a.Kv, a.G, a.S, a.T);
  return cudaGetLastError();
}

template <bool PAGED>
cudaError_t dispatch(int hd, int is_bf16, const Args& a, cudaStream_t s) {
  if (is_bf16) {
    if (a.T <= 0 || a.T > kMaxT || a.n_splits <= 0 || a.scratch == nullptr)
      return cudaErrorInvalidValue;
    if (hd == 64) return launch_tc<64, PAGED>(a, s);
    if (hd == 112) return launch_tc<112, PAGED>(a, s);
    if (hd == 128) return launch_tc<128, PAGED>(a, s);
    if (hd == 256) return launch_tc<256, PAGED>(a, s);
    return cudaErrorInvalidValue;
  }
  // shared memory (f32_smem): 25 KB at head_dim 64, 37 KB at 112, 41 KB
  // at 128, 82 KB at 256 (the opt-in above 48 KB). At 112 a block holds 8
  // rows, one a warp: with 16, ptxas kept the instance at 48 registers and
  // spilled
  if (hd == 64) return launch_fp32<64, 32, PAGED>(a, s);
  if (hd == 112) return launch_fp32<112, 8, PAGED>(a, s);
  if (hd == 128) return launch_fp32<128, 16, PAGED>(a, s);
  if (hd == 256) return launch_fp32<256, 16, PAGED>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, Bq, Kv, G, hd) and k/v_blk (b, Bq, Kv, hd) contiguous; k/v cache
// (b, S, Kv, hd) with element strides (c_sb, c_ss, c_sk, 1); cache_lens
// (b,) int32; out (b, Bq, Kv, G, hd) fp32. softcap <= 0 and window <= 0
// mean none. bf16 runs on the tensor cores in n_splits splits of T key
// tiles (ref.py::split_plan), with `scratch` of n_splits * b * Kv * Bq G *
// (hd + 2) floats (16-byte aligned), then merged by a second kernel; fp32
// on CUDA cores (T, n_splits and scratch unused). Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (cudaErrorInvalidValue for
// a head_dim other than 64, 112, 128 or 256).
extern "C" int decode_attn_forward(
    const void* q, const void* kc, const void* vc, const void* kb,
    const void* vb, const void* cache_lens, void* out, void* scratch, int b,
    int Bq, int Kv, int G, int hd, int S, int T, int n_splits, long long c_sb,
    long long c_ss, long long c_sk, float scale, float softcap, int window,
    int is_bf16, void* stream) {
  const Args a{q,  kc, vc, kb, vb, cache_lens, nullptr, out,   scratch,
               b,  Bq, Kv, G,  S,  0,          1,       T,     n_splits,
               c_sb, c_ss, c_sk, scale, softcap, window};
  return dispatch<false>(hd, is_bf16, a, static_cast<cudaStream_t>(stream));
}

// The paged variant: k/v pool (n_pages, page, Kv, hd) with element strides
// (p_sp, p_ss, p_sk, 1) (a period slice of the stacked pool); page_table
// (b, n_t) int32, -1 = unallocated; S = n_t * page; the rest as
// decode_attn_forward.
extern "C" int paged_decode_attn_forward(
    const void* q, const void* kp, const void* vp, const void* kb,
    const void* vb, const void* page_table, const void* cache_lens, void* out,
    void* scratch, int b, int Bq, int Kv, int G, int hd, int n_t, int page,
    int T, int n_splits, long long p_sp, long long p_ss, long long p_sk,
    float scale, float softcap, int window, int is_bf16, void* stream) {
  const Args a{q,  kp, vp, kb, vb, cache_lens, page_table, out, scratch,
               b,  Bq, Kv, G,  n_t * page, n_t, page,     T,   n_splits,
               p_sp, p_ss, p_sk, scale, softcap, window};
  return dispatch<true>(hd, is_bf16, a, static_cast<cudaStream_t>(stream));
}
