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
// 16k-long chain carries |W_y| and rounds at that scale).
// No (T, V) tensor is ever written: the forward keeps per-row running
// statistics, the backward recomputes the logits one vocab chunk at a time
// into a (T, chunk) fp32 scratch.
//
// What bounds it on this card: at the training path's shapes (T = b x G =
// 1,024 rows, d = 896, V = 151,936, bf16) the forward is 2 T V d = 279
// GFLOP and the backward three such products, 836 GFLOP; W is 272 MB. At
// the tensor cores' 989 TFLOP/s that is 0.28 and 0.85 ms, against 0.08 ms
// to read W once: operations bound both. These first kernels run the
// products on CUDA cores in fp32 (64 x 64 x 32 shared-memory tiles, 4 x 4
// outputs per thread, select.cu's scheme), whose peak is some 67 TFLOP/s,
// so they take milliseconds; wgmma/TMA tiles are a later change.
// What the design does:
//  - forward: the vocabulary is split into chunks across blocks (block =
//    (row tile, chunk), row tile fastest so blocks sharing W rows run
//    together); each block folds its 64 x 64 logit tiles into per-row
//    running (max, sum-exp) and picks up the target logit from the tile
//    that holds it; a second small kernel merges the chunks of each row in
//    vocab order. The ragged vocab edge is masked here (the JAX wrapper
//    instead picks a tile that divides V).
//  - backward: one host-side loop of launches per vocab chunk: probs (the
//    logits recomputed, e = exp(lo - logz) g formed in the epilogue),
//    dh += e W_chunk (each element owned by one thread, chunks in order),
//    dW_chunk = (e - 1[v = y] g)^T h (the one-hot applied as the tile is
//    loaded; the whole T reduction inside one block). No atomics: two runs
//    give bit-identical gradients. dh is summed in fp32; the last kernel
//    subtracts g W_y and casts.
// Both take fp32 or bf16 h and W (the same dtype) and accumulate in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
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
// (n_chunks, T) fp32 scratch. Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int xent_forward(const void* h, const void* w, const void* y,
                            void* loss, void* logz, void* part_m,
                            void* part_l, void* part_t, int n_rows, int V,
                            int d, int per_chunk, int n_chunks, int is_bf16,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return forward<__nv_bfloat16>(h, w, y, loss, logz, part_m, part_l,
                                  part_t, n_rows, V, d, per_chunk, n_chunks,
                                  s);
  return forward<float>(h, w, y, loss, logz, part_m, part_l, part_t, n_rows,
                        V, d, per_chunk, n_chunks, s);
}

// As above, plus logz and g (T,) fp32; dh (T, d) in h's dtype and dw (V, d)
// in w's dtype (outputs; dw may be null: no dW); dh_acc (T, d) and probs
// (T, chunk) fp32 scratch, chunk a multiple of 64.
extern "C" int xent_backward(const void* h, const void* w, const void* y,
                             const void* logz, const void* g, void* dh,
                             void* dw, void* dh_acc, void* probs, int n_rows,
                             int V, int d, int chunk, int is_bf16,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(dh_acc);
  float* p = static_cast<float*>(probs);
  if (is_bf16)
    return backward<__nv_bfloat16>(h, w, y, logz, g, dh, dw, acc, p, n_rows,
                                   V, d, chunk, s);
  return backward<float>(h, w, y, logz, g, dh, dw, acc, p, n_rows, V, d,
                         chunk, s);
}
