// The forward's elementwise chains between its matmuls, for Hopper (sm_90a):
// residual add + RMSNorm, QKV bias + RoPE, and the gated activation.
//
// Replaces no Pallas kernel: on the TPU, XLA fused these ops into the
// matmuls around them. In PyTorch each op of a chain is its own kernel (an
// fp32 upcast, a square, a mean, an rsqrt, two products and a cast for one
// norm; an arange, an exp, a cos, a sin, four products, a sum, a difference,
// a cat and a cast for one RoPE), about 55 launches a layer, each reading
// and writing its fp32 intermediate in device memory. Here each chain is one
// pass that reads its inputs once, keeps every intermediate in registers,
// and writes its outputs once.
//
// What bounds them on this card: bytes. None does more than a few
// operations per byte (the norm's reduction, RoPE's sincos of one row's
// angles), far below the ~295 FLOP/byte where the tensor cores would be the
// limit. So the design is about memory traffic and latency: 16-byte vector
// loads and stores (8 bf16 a thread), each input read once, no scratch
// buffer, and, at the 32 rows of a single-lane block, enough threads per row
// that each row finishes in one short trip through memory.
//
// Numerics are the plain path's (models/layers.py), rounded to bf16 at the
// same points: the residual sum before the norm, the bias sum before RoPE,
// act(g) before the product. Between those points everything stays in fp32,
// with the products and sums that the plain path rounds one at a time
// written as __fmul_rn / __fadd_rn so that the compiler fuses none of them
// into an FMA. The norm's sum of squares runs in another order than
// PyTorch's reduction, so h may differ from the plain path's by one bf16
// ulp where the fp32 mean rounds differently; the rest is the same work on
// the same values.
//
//  - add_rmsnorm_kernel: one block of 256 threads per row. Each thread holds
//    up to 4 vectors of the row (d <= 8192) in registers: the residual sum
//    x + delta (written out once), its square summed in fp32, one block
//    reduction, then h = (x * rsqrt(mean + eps)) * w. Without delta (the
//    first layer's norm1) it reads x and writes h only.
//  - qkv_rope_kernel: one block per token row. The row's angles pos * freq
//    (freq = exp(-i * ln(theta) / half), as the plain path builds them) go
//    through accurate cosf / sinf (angles reach ~1e3 rad, beyond the fast
//    intrinsics' range) into shared memory once; then each thread takes
//    8-wide chunks of the (x1, x2) halves of the q and k heads, adds the
//    bias, rotates, and writes; and the v bias where the config has one.
//    The QKN instance (a config with Qwen3's QK-norm) RMS-normalises each
//    head of q and k between the bias and the rotation: the head's chunks
//    lie in `half / 8` neighbouring lanes of one warp (a power of two: hd
//    64, 128 or 256), which sum their squares by shuffles, and each value is
//    scaled by the head's rsqrt and its (hd,) weight, rounded to bf16 as the
//    plain path's norm output is. Without it the instance is the kernel as
//    it was.
//  - gated_act_kernel: act(g) * u, 8 elements a thread, for silu and for
//    the tanh gelu (the expression PyTorch's own kernel evaluates).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kNormThreads = 256;
constexpr int kNormVecs = 4;        // 16-byte vectors a thread holds
constexpr int kRopeThreads = 256;
constexpr int kRopeMaxHalf = 128;   // head_dim <= 256
constexpr int kActThreads = 256;

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

// x (rows, d) bf16, delta (rows, d) bf16 or null, w (d,) bf16; x_out (rows,
// d) = bf16(x + delta) (unused without delta), h (rows, d) = the norm.
// inv_d is PyTorch's mean factor, rows / (rows * d) in fp32.
__global__ void __launch_bounds__(kNormThreads)
add_rmsnorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta,
                   const bf16* __restrict__ w, bf16* __restrict__ x_out,
                   bf16* __restrict__ h, int d, float inv_d, float eps) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const int nvec = d / 8;
  float s[kNormVecs][8];
  float dl[kNormVecs][8];
#pragma unroll
  for (int i = 0; i < kNormVecs; ++i) {
    const int v = threadIdx.x + i * kNormThreads;
    if (v < nvec) {
      load8(x + base + v * 8, s[i]);
      if (delta != nullptr) load8(delta + base + v * 8, dl[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kNormVecs; ++i) {
    const int v = threadIdx.x + i * kNormThreads;
    if (v < nvec) {
      if (delta != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = round_bf16(__fadd_rn(s[i][j], dl[i][j]));
        store8(x_out + base + v * 8, s[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(s[i][j], s[i][j]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  __shared__ float part[kNormThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kNormThreads / 32; ++i) total += part[i];
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_d), eps));
#pragma unroll
  for (int i = 0; i < kNormVecs; ++i) {
    const int v = threadIdx.x + i * kNormThreads;
    if (v < nvec) {
      float wv[8];
      load8(w + v * 8, wv);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = __fmul_rn(__fmul_rn(s[i][j], r), wv[j]);
      store8(h + base + v * 8, s[i]);
    }
  }
}

// One token row per block. q (rows, n_q * hd), k and v (rows, n_kv * hd),
// biases (n * hd,) or null; positions pos[b * pos_sb + l * pos_sl] for row
// b * L + l. Writes q_out, k_out and, with bv, v_out (same layouts).
// log_step = fp32(ln(theta) / half), the plain path's frequency scale.
// QKN: qn and kn (hd,) are the QK-norm's weights, inv_q and inv_k the mean's
// factors of q's and k's heads (PyTorch's), eps the norm's.
template <bool QKN>
__global__ void __launch_bounds__(kRopeThreads)
qkv_rope_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ bq,
                const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                const int64_t* __restrict__ pos, int64_t pos_sb,
                int64_t pos_sl, int L, bf16* __restrict__ q_out,
                bf16* __restrict__ k_out, bf16* __restrict__ v_out, int n_q,
                int n_kv, int hd, float log_step,
                const bf16* __restrict__ qn, const bf16* __restrict__ kn,
                float inv_q, float inv_k, float eps) {
  __shared__ float cs[kRopeMaxHalf];
  __shared__ float sn[kRopeMaxHalf];
  const int64_t row = blockIdx.x;
  const int half = hd / 2;
  const float p = static_cast<float>(pos[(row / L) * pos_sb + (row % L) * pos_sl]);
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float ang = __fmul_rn(p, expf(__fmul_rn(-static_cast<float>(i), log_step)));
    cs[i] = cosf(ang);
    sn[i] = sinf(ang);
  }
  __syncthreads();
  const int chunks = half / 8;
  const int rope_units = (n_q + n_kv) * chunks;
  const int units = rope_units + (bv != nullptr ? n_kv * hd / 8 : 0);
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    if (u < rope_units) {
      const int head = u / chunks;
      const int c = (u % chunks) * 8;
      const bool is_q = head < n_q;
      const int hh = is_q ? head : head - n_q;
      const int64_t off = row * (is_q ? n_q : n_kv) * hd + hh * hd + c;
      const bf16* src = is_q ? q : k;
      const bf16* bias = is_q ? bq : bk;
      bf16* dst = is_q ? q_out : k_out;
      float x1[8], x2[8], o1[8], o2[8];
      load8(src + off, x1);
      load8(src + off + half, x2);
      if (bias != nullptr) {
        float b1[8], b2[8];
        load8(bias + hh * hd + c, b1);
        load8(bias + hh * hd + c + half, b2);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          x1[j] = round_bf16(__fadd_rn(x1[j], b1[j]));
          x2[j] = round_bf16(__fadd_rn(x2[j], b2[j]));
        }
      }
      if constexpr (QKN) {
        float ss = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ss = __fadd_rn(ss, __fmul_rn(x1[j], x1[j]));
          ss = __fadd_rn(ss, __fmul_rn(x2[j], x2[j]));
        }
        // the head's `chunks` lanes: aligned, neighbouring, one warp
        const unsigned lane = threadIdx.x & 31;
        const unsigned group =
            chunks == 32 ? 0xffffffffu
                         : ((1u << chunks) - 1u) << (lane & ~(chunks - 1u));
        for (int o = 1; o < chunks; o <<= 1) ss += __shfl_xor_sync(group, ss, o);
        const float r =
            rsqrtf(__fadd_rn(__fmul_rn(ss, is_q ? inv_q : inv_k), eps));
        const bf16* nw = is_q ? qn : kn;
        float w1[8], w2[8];
        load8(nw + c, w1);
        load8(nw + c + half, w2);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          x1[j] = round_bf16(__fmul_rn(__fmul_rn(x1[j], r), w1[j]));
          x2[j] = round_bf16(__fmul_rn(__fmul_rn(x2[j], r), w2[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float cj = cs[c + j], sj = sn[c + j];
        o1[j] = __fsub_rn(__fmul_rn(x1[j], cj), __fmul_rn(x2[j], sj));
        o2[j] = __fadd_rn(__fmul_rn(x2[j], cj), __fmul_rn(x1[j], sj));
      }
      store8(dst + off, o1);
      store8(dst + off + half, o2);
    } else {
      const int e = (u - rope_units) * 8;
      const int64_t off = row * n_kv * hd + e;
      float a[8], b[8];
      load8(v + off, a);
      load8(bv + e, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = __fadd_rn(a[j], b[j]);
      store8(v_out + off, a);
    }
  }
}

// PyTorch's silu: x / (1 + exp(-x)) in fp32.
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// PyTorch's tanh gelu (F.gelu(approximate="tanh")), its expression as its
// CUDA kernel writes it.
__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = 1.41421356237309504880 * 1.12837916709551257390 * 0.5;
  constexpr float kKappa = 0.044715;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// out = bf16(bf16(act(g)) * u), n_vec vectors of 8.
template <int KIND>
__global__ void __launch_bounds__(kActThreads)
gated_act_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u,
                 bf16* __restrict__ out, int64_t n_vec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kActThreads + threadIdx.x;
  if (i >= n_vec) return;
  float a[8], b[8];
  load8(g + i * 8, a);
  load8(u + i * 8, b);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float act = KIND == 0 ? silu(a[j]) : gelu_tanh(a[j]);
    a[j] = __fmul_rn(round_bf16(act), b[j]);
  }
  store8(out + i * 8, a);
}

}  // namespace

// Every pointer 16-byte aligned, every tensor contiguous, d % 8 == 0 and
// d <= 8192 (the wrapper checks). delta may be null (then x_out is unused).
extern "C" int ew_add_rmsnorm(const void* x, const void* delta, const void* w,
                              void* x_out, void* h, int64_t rows, int d,
                              float inv_d, float eps, void* stream) {
  if (rows == 0) return cudaSuccess;
  add_rmsnorm_kernel<<<static_cast<unsigned>(rows), kNormThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(delta),
      static_cast<const bf16*>(w), static_cast<bf16*>(x_out),
      static_cast<bf16*>(h), d, inv_d, eps);
  return cudaGetLastError();
}

// hd % 16 == 0 and hd <= 256; biases may be null (v_out unused without bv).
// qn and kn both null, or both (hd,) with hd 64, 128 or 256: the QK-norm.
extern "C" int ew_qkv_rope(const void* q, const void* k, const void* v,
                           const void* bq, const void* bk, const void* bv,
                           const void* pos, int64_t pos_sb, int64_t pos_sl,
                           int64_t rows, int L, void* q_out, void* k_out,
                           void* v_out, int n_q, int n_kv, int hd,
                           float log_step, const void* qn, const void* kn,
                           float inv_q, float inv_k, float eps, void* stream) {
  if (rows == 0) return cudaSuccess;
  auto kernel = qn != nullptr ? qkv_rope_kernel<true> : qkv_rope_kernel<false>;
  kernel<<<static_cast<unsigned>(rows), kRopeThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(bq),
      static_cast<const bf16*>(bk), static_cast<const bf16*>(bv),
      static_cast<const int64_t*>(pos), pos_sb, pos_sl, L,
      static_cast<bf16*>(q_out), static_cast<bf16*>(k_out),
      static_cast<bf16*>(v_out), n_q, n_kv, hd, log_step,
      static_cast<const bf16*>(qn), static_cast<const bf16*>(kn), inv_q,
      inv_k, eps);
  return cudaGetLastError();
}

// n % 8 == 0; kind 0 silu, 1 tanh gelu.
extern "C" int ew_gated_act(const void* g, const void* u, void* out,
                            int64_t n, int kind, void* stream) {
  const int64_t n_vec = n / 8;
  if (n_vec == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((n_vec + kActThreads - 1) / kActThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* gp = static_cast<const bf16*>(g);
  const bf16* up = static_cast<const bf16*>(u);
  bf16* op = static_cast<bf16*>(out);
  if (kind == 0) {
    gated_act_kernel<0><<<grid, kActThreads, 0, s>>>(gp, up, op, n_vec);
  } else {
    gated_act_kernel<1><<<grid, kActThreads, 0, s>>>(gp, up, op, n_vec);
  }
  return cudaGetLastError();
}
