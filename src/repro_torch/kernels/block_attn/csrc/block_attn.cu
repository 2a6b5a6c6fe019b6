// Full-sequence attention with CDLM visibility (bidirectional, causal or
// block-causal), for Hopper (sm_90a): the prompt prefill of every admission.
//
// Replaces the TPU kernel src/repro/kernels/block_attn/block_attn.py::
// block_attention (body _flash_kernel, visibility _tile_visibility) and the
// padding its wrapper ops.py::flash_block_attention does around it.
//
// The TPU kernel walks a sequential grid axis over key tiles and carries
// (m, l, acc) in scratch from one grid step to the next. Hopper blocks run
// in no order and share nothing, so here one block owns a tile of query
// rows of one (lane, KV head) and loops over the key tiles itself, with the
// online softmax in registers:
//  - the GQA group is folded into the rows (row = qpos * G + g), so the G
//    query heads that share a KV head share every K/V tile loaded to shared
//    memory, and no G-fold copy of K/V exists;
//  - the block visits only the key tiles its rows can see: up to the end of
//    its last row's CDLM block (causal: its last position), and from
//    q - window + 1 with a window. Inside a tile, visibility is decided per
//    (query, key) exactly as _tile_visibility does: prompt positions form
//    block -1, the others (pos - prompt_len) / block_size; with a window,
//    q - k < window under causal and |q - k| < window otherwise. Softcap
//    comes before the mask; the output is normalized by max(l, 1e-30);
//  - the ragged edge of L is masked here (keys at or past L are never
//    visible), so the wrapper pads nothing;
//  - one warp owns a query row at a time: lane j scores key j of a 32-key
//    tile, the warp reduces max and sum with shuffles, and each lane keeps
//    hd/32 output columns in registers. CUDA cores in fp32.
//
// What bounds it on this card: at the prefill shape (8 lanes, 512
// positions, 2 KV heads of 7 query heads, head_dim 64, bf16, everything
// visible) one call does about 7.5 GFLOP and moves about 24 MB: both
// bounds near 7 us, at the tensor cores' bf16 rate. This kernel runs its
// products on CUDA cores in fp32 from shared memory, so it is bound by
// shared-memory loads and FMA throughput, far above that; wgmma and TMA
// are the later work that would approach it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 32;  // keys per shared-memory tile (one per lane)
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kBidirectional = 0, kCausal = 1, kBlockCausal = 2 };

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

// grid: (ceil(L*G / ROWS), Kv, b); block: kThreads. q (b, L, Kv, G, hd),
// k/v (b, L, Kv, hd) contiguous; out (b, L, Kv, G, hd) fp32.
template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads)
block_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, float* __restrict__ out, int L,
                  int Kv, int G, int mode, int prompt_len, int block_size,
                  int window, float scale, float softcap) {
  constexpr int kRowsPerWarp = ROWS / kWarps;
  constexpr int kColsPerLane = HD / 32;
  __shared__ float sq[ROWS][HD];
  __shared__ float sk[kTileK][HD + 1];  // +1: lane j reads row j conflict-free
  __shared__ float sv[kTileK][HD];

  const int rows = L * G;
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
          ((((long long)lb * L + row / G) * Kv + kvh) * G + row % G) * HD + d;
      x = to_float(q[off]) * scale;
    }
    sq[r][d] = x;
  }

  // the keys any row of this block can see: [k_begin, k_end)
  const int q_lo = row0 / G;
  const int q_hi = (min(row0 + ROWS, rows) - 1) / G;
  int k_begin = 0, k_end = L;
  if (mode == kCausal)
    k_end = q_hi + 1;
  else if (mode == kBlockCausal)
    k_end = prompt_len +
            (cdlm_block(q_hi, prompt_len, block_size) + 1) * block_size;
  if (window > 0) {
    k_begin = max(0, q_lo - window + 1);
    if (mode != kCausal) k_end = min(k_end, q_hi + window);
  }
  k_end = min(k_end, L);

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
    for (int idx = tid; idx < kTileK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD, kp = k0 + j;
      float xk = 0.f, xv = 0.f;
      if (kp < L) {
        const long long off = (((long long)lb * L + kp) * Kv + kvh) * HD + d;
        xk = to_float(k[off]);
        xv = to_float(v[off]);
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
      const int qp = row / G;
      const int kp = k0 + lane;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += sq[r][d] * sk[lane][d];
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
        ((((long long)lb * L + row / G) * Kv + kvh) * G + row % G) * HD;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      out[base + lane + 32 * c] = acc[i][c] * inv;
  }
}

template <typename T, int HD, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int L, int Kv, int G, int mode, int prompt_len,
                   int block_size, int window, float scale, float softcap,
                   cudaStream_t stream) {
  const dim3 grid((L * G + ROWS - 1) / ROWS, Kv, b);
  block_attn_kernel<T, HD, ROWS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(out), L, Kv, G, mode,
      prompt_len, block_size, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* out, int b, int L, int Kv, int G, int mode,
                     int prompt_len, int block_size, int window, float scale,
                     float softcap, cudaStream_t stream) {
  // shared memory: ROWS*HD + 32*(HD+1) + 32*HD floats stays under 48 KB
  if (hd == 64)
    return launch<T, 64, 64>(q, k, v, out, b, L, Kv, G, mode, prompt_len,
                             block_size, window, scale, softcap, stream);
  if (hd == 128)
    return launch<T, 128, 16>(q, k, v, out, b, L, Kv, G, mode, prompt_len,
                              block_size, window, scale, softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (b, L, Kv, G, hd) and k/v (b, L, Kv, hd) contiguous; out (b, L, Kv, G,
// hd) fp32. mode: 0 bidirectional, 1 causal, 2 block_causal; block_size >
// 0; softcap <= 0 and window <= 0 mean none. Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int block_attn_forward(const void* q, const void* k,
                                  const void* v, void* out, int b, int L,
                                  int Kv, int G, int hd, int mode,
                                  int prompt_len, int block_size, int window,
                                  float scale, float softcap, int is_bf16,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, out, b, L, Kv, G, mode,
                                   prompt_len, block_size, window, scale,
                                   softcap, s);
  return dispatch<float>(hd, q, k, v, out, b, L, Kv, G, mode, prompt_len,
                         block_size, window, scale, softcap, s);
}
