// Decode attention of the CDLM active block, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/decode_attn.py::
// decode_attention_partial (body _decode_kernel), together with the work
// its wrapper ops.py::decode_attention does around it in jnp
// (_block_partial and softmax_combine): here one kernel runs the cache rows
// below each lane's cache_len and then the block's own fresh keys through
// one fp32 online softmax and writes the normalized output.
//
// What bounds it on this card: very little work per call. At the main
// path's shapes (qwen2-0.5b: 8 lanes, a 32-token block, 2 KV heads of
// 7 query heads, head_dim 64, caches of a few hundred rows, bf16) one call
// reads about 3.5 MB, about 1 us at 3.35 TB/s, and does about 0.2 GFLOP;
// its time is set by the launch and by a grid of ~100 blocks, not by bytes.
// The design therefore stays simple:
//  - one block per (lane, KV head, tile of query rows). The GQA group is
//    folded into the rows (row = qpos * G + g), so the G query heads that
//    share a KV head share every K/V tile loaded to shared memory;
//  - cache_lens is a (b,) tensor: lanes decode at different offsets, and a
//    block loops over key tiles only up to its own lane's length;
//  - the cache is read in its model layout (b, S, Kv, hd) through strides,
//    so no per-call transpose copies the cache;
//  - one warp owns a query row at a time: lane j scores key j of a 32-key
//    tile, the warp reduces max and sum with shuffles, and each lane keeps
//    hd/32 output columns in registers. CUDA cores in fp32; tensor cores,
//    TMA and warp specialisation are left for when the call is worth it.
// Masking follows the JAX kernel: softcap first, then visibility. Against
// the cache a key is visible when kpos < cache_len and, with a window,
// qpos - kpos < window where qpos = cache_len + row / G; inside the block
// when |row / G - kpos| < window.
//
// The paged variant (PAGED = true) also replaces the TPU kernel
// decode_attn.py::paged_decode_attention_partial (body
// _paged_decode_kernel) and the jnp merge around it in ops.py::
// paged_decode_attention. The cache is a pool (n_pages, page, Kv, hd) shared
// by the lanes, and key kp of lane lb lives at row kp % page of pool page
// page_table[lb, kp / page]. That address is the only difference from the
// dense kernel: the keys run in the same 32-key tiles in the same order
// through the same arithmetic, so on an identity table (and equal contents)
// the two kernels give the same bits, for any page size. Only keys below
// cache_len are loaded, and a FREE (-1) entry is never dereferenced: its
// keys are skipped, as the TPU kernel skips such pages. Pool pages are not
// zeroed when freed; nothing at or past cache_len is read, so their
// residue never reaches the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 32;  // keys per shared-memory tile (one per lane)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// grid: (ceil(Bq*G / ROWS), Kv, b); block: kThreads. Dense: the cache is
// (b, S, Kv, hd) with strides (c_sb, c_ss, c_sk, 1). Paged: the pool is
// (n_pages, page, Kv, hd) with strides (c_sb, c_ss, c_sk, 1), page_table is
// (b, n_t) int32 and S = n_t * page.
template <typename T, int HD, int ROWS, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const T* __restrict__ kb,
                   const T* __restrict__ vb,
                   const int* __restrict__ cache_lens,
                   const int* __restrict__ page_table,
                   float* __restrict__ out, int Bq, int Kv, int G, int S,
                   int n_t, int page, long long c_sb, long long c_ss,
                   long long c_sk, float scale, float softcap, int window) {
  constexpr int kRowsPerWarp = ROWS / kWarps;
  constexpr int kColsPerLane = HD / 32;
  __shared__ float sq[ROWS][HD];
  __shared__ float sk[kTileK][HD + 1];  // +1: lane j reads row j conflict-free
  __shared__ float sv[kTileK][HD];
  __shared__ bool s_ok[kTileK];  // paged: the key's page is allocated

  const int rows = Bq * G;
  const int row0 = blockIdx.x * ROWS;
  const int kvh = blockIdx.y;
  const int lb = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int idx = tid; idx < ROWS * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = row0 + r;
    float x = 0.f;
    if (row < rows) {
      const long long off =
          ((((long long)lb * Bq + row / G) * Kv + kvh) * G + row % G) * HD + d;
      x = to_float(q[off]) * scale;
    }
    sq[r][d] = x;
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
    for (int idx = tid; idx < kTileK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, kp = k0 + j;
      float xk = 0.f, xv = 0.f;
      if (kp < klimit) {
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
            xk = to_float(kc[off]);
            xv = to_float(vc[off]);
          }
        } else {
          const long long off = (((long long)lb * Bq + kp) * Kv + kvh) * HD + d;
          xk = to_float(kb[off]);
          xv = to_float(vb[off]);
        }
      }
      sk[j][d] = xk;
      sv[j][d] = xv;
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
      for (int d = 0; d < HD; ++d) s += sq[r][d] * sk[lane][d];
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
          acc[i][c] += pj * sv[j][lane + 32 * c];
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
      out[base + lane + 32 * c] = acc[i][c] * inv;
  }
}

struct Args {
  const void *q, *kc, *vc, *kb, *vb, *cache_lens, *page_table;
  void* out;
  int b, Bq, Kv, G, S, n_t, page;
  long long c_sb, c_ss, c_sk;
  float scale, softcap;
  int window;
};

template <typename T, int HD, int ROWS, bool PAGED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.Bq * a.G + ROWS - 1) / ROWS, a.Kv, a.b);
  decode_attn_kernel<T, HD, ROWS, PAGED><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), static_cast<const T*>(a.kb),
      static_cast<const T*>(a.vb), static_cast<const int*>(a.cache_lens),
      static_cast<const int*>(a.page_table), static_cast<float*>(a.out),
      a.Bq, a.Kv, a.G, a.S, a.n_t, a.page, a.c_sb, a.c_ss, a.c_sk, a.scale,
      a.softcap, a.window);
  return cudaGetLastError();
}

template <bool PAGED>
cudaError_t dispatch(int hd, int is_bf16, const Args& a, cudaStream_t s) {
  // shared memory: ROWS*HD + 32*(HD+1) + 32*HD floats stays under 48 KB
  if (hd == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64, 32, PAGED>(a, s)
                   : launch<float, 64, 32, PAGED>(a, s);
  if (hd == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128, 16, PAGED>(a, s)
                   : launch<float, 128, 16, PAGED>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, Bq, Kv, G, hd) and k/v_blk (b, Bq, Kv, hd) contiguous; k/v cache
// (b, S, Kv, hd) with element strides (c_sb, c_ss, c_sk, 1); cache_lens
// (b,) int32; out (b, Bq, Kv, G, hd) fp32. softcap <= 0 and window <= 0
// mean none. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int decode_attn_forward(const void* q, const void* kc,
                                   const void* vc, const void* kb,
                                   const void* vb, const void* cache_lens,
                                   void* out, int b, int Bq, int Kv, int G,
                                   int hd, int S, long long c_sb,
                                   long long c_ss, long long c_sk, float scale,
                                   float softcap, int window, int is_bf16,
                                   void* stream) {
  const Args a{q,  kc, vc, kb,   vb,   cache_lens, nullptr, out,
               b,  Bq, Kv, G,    S,    0,          1,       c_sb,
               c_ss, c_sk, scale, softcap, window};
  return dispatch<false>(hd, is_bf16, a, static_cast<cudaStream_t>(stream));
}

// The paged variant: k/v pool (n_pages, page, Kv, hd) with element strides
// (p_sp, p_ss, p_sk, 1) (a period slice of the stacked pool); page_table
// (b, n_t) int32, -1 = unallocated; the rest as decode_attn_forward.
extern "C" int paged_decode_attn_forward(
    const void* q, const void* kp, const void* vp, const void* kb,
    const void* vb, const void* page_table, const void* cache_lens, void* out,
    int b, int Bq, int Kv, int G, int hd, int n_t, int page, long long p_sp,
    long long p_ss, long long p_sk, float scale, float softcap, int window,
    int is_bf16, void* stream) {
  const Args a{q,  kp, vp, kb,        vb,  cache_lens, page_table, out,
               b,  Bq, Kv, G,         n_t * page, n_t,  page,       p_sp,
               p_ss, p_sk, scale, softcap, window};
  return dispatch<true>(hd, is_bf16, a, static_cast<cudaStream_t>(stream));
}
