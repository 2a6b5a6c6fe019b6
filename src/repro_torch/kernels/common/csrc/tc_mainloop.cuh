// The tensor-core logit-tile mainloop shared by the port's kernels that
// compute a tile of h W^T (xent.cu's forward and probabilities, select.cu's
// candidate selection): a ring of shared-memory stages filled by TMA and
// paced by mbarriers, one producer warp and two consumer warpgroups of 64
// rows, and the 128 x 128 logit tile summed stage by stage in fp32.
// block_attn.cu uses the ring, the cursor and the accumulator fragment's
// (row, column) map. Built on hopper.cuh.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace tc {

constexpr int kTile = 128;          // rows of every output tile (2 x 64)
constexpr int kBK = hopper::kBox;   // depth per stage
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kTileBytes = 2 * hopper::kBoxBytes;  // 128 x 64 bf16, 16 KB
// logit tiles: a stage holds the h tile and the W tile
constexpr int kLogitStages = 4;
constexpr int kLogitStage = 2 * kTileBytes;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kLogitSmem = kLogitStages * kLogitStage + 1024 + 256;

struct Ring {
  char* data;       // stage s at data + s * stage_bytes, 1024-byte aligned
  uint64_t* full;   // TMA landed (1 arrival + bytes)
  uint64_t* empty;  // both consumer warpgroups done (2 arrivals)
};

// Carves the dynamic shared memory into a ring of `stages` and sets up its
// barriers; *rest is the shared memory after the barriers.
__device__ __forceinline__ Ring ring_init(char* raw, int stages,
                                          int stage_bytes, char** rest) {
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  Ring r;
  r.data = base;
  r.full = reinterpret_cast<uint64_t*>(base + stages * stage_bytes);
  r.empty = r.full + stages;
  *rest = reinterpret_cast<char*>(r.empty + stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::bar_init(&r.full[s], 1);
      hopper::bar_init(&r.empty[s], 2);
    }
    hopper::bar_fence_init();
  }
  __syncthreads();
  return r;
}

// Position in a ring walked in order by the producer and the consumers.
struct Cursor {
  int stage = 0, phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Producer: the h and W k-slices of the logit tile (rows t0.., vocab rows
// v..) for every k-stage of depth d.
__device__ __forceinline__ void load_logit_tile(const Ring& r, Cursor& c,
                                                const CUtensorMap* hmap,
                                                const CUtensorMap* wmap,
                                                int t0, int v, int nk) {
  for (int kb = 0; kb < nk; ++kb) {
    hopper::bar_wait(&r.empty[c.stage], c.phase ^ 1);
    char* st = r.data + c.stage * kLogitStage;
    uint64_t* bar = &r.full[c.stage];
    hopper::bar_expect_tx(bar, kLogitStage);
    const int k = kb * kBK;
    hopper::tma_load(st, hmap, bar, k, t0);
    hopper::tma_load(st + hopper::kBoxBytes, hmap, bar, k, t0 + 64);
    hopper::tma_load(st + kTileBytes, wmap, bar, k, v);
    hopper::tma_load(st + kTileBytes + hopper::kBoxBytes, wmap, bar, k,
                     v + 64);
    c.next(kLogitStages);
  }
}

// Consumer warpgroup of a product tile: acc = the sum over the nk k-stages
// of the ring of issue(acc, stage, add), the products accumulating in acc,
// one stage's wgmma group in flight while the next is issued. A stage is
// freed as soon as the products that read it are done.
template <int STAGES, int STAGE_BYTES, int N, typename Issue>
__device__ __forceinline__ void consume(const Ring& r, Cursor& c,
                                        float (&acc)[N], int nk,
                                        bool signal, Issue issue) {
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb) {
    hopper::bar_wait(&r.full[c.stage], c.phase);
    hopper::wgmma_fence();
    issue(acc, r.data + c.stage * STAGE_BYTES, kb > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (prev >= 0 && signal) hopper::bar_arrive(&r.empty[prev]);
    prev = c.stage;
    c.next(STAGES);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_acc(acc);
  if (signal) hopper::bar_arrive(&r.empty[prev]);
}

// acc[base + j] = (first ? 0 : acc[base + j]) + p[j], j < 32: a stage's
// partial added into the running logits in fp32, with rounding.
template <int BASE>
__device__ __forceinline__ void promote(float (&acc)[64], float (&p)[32],
                                        bool first) {
  hopper::fence_acc(p);
#pragma unroll
  for (int j = 0; j < 32; ++j)
    acc[BASE + j] = first ? p[j] : acc[BASE + j] + p[j];
}

// Consumer warpgroup `wg`: acc = its 64 rows of the logit tile (x 128
// vocab rows), K-major h and W. The tensor cores add a k-step's products
// into their accumulator with truncation, an error of about one ulp of the
// running sum per step, biased: over d = 896 a logit of 150 would be some
// 2e-4 off. So each stage's 64-deep products are made in a fresh partial
// and added into acc in fp32 with rounding; the truncation then acts only at
// the partials' size. The 128 columns go as two halves of 64 (m64n64k16)
// into two partials, and each half's products run while the other half's
// partial is added: the sum and both partials fit in 128 registers. One
// wgmma group is in flight at a time, and the partial read meanwhile is
// never written inside that group's window, so ptxas keeps the wgmma
// asynchronous.
__device__ __forceinline__ void logit_tile(const Ring& r, Cursor& c,
                                           float (&acc)[64], int wg, int nk,
                                           bool signal) {
  float p0[32], p1[32];
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb) {
    hopper::bar_wait(&r.full[c.stage], c.phase);
    const char* st = r.data + c.stage * kLogitStage;
    const char* a = st + wg * hopper::kBoxBytes;
    const char* b = st + kTileBytes;
    hopper::wgmma_wait<0>();  // the previous stage's second half
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      hopper::wgmma_64<0, 0>(p0, hopper::desc_k(a, ks),
                             hopper::desc_k(b, ks), ks > 0);
    hopper::wgmma_commit();
    if (kb > 0) {
      promote<32>(acc, p1, kb == 1);
      if (signal) hopper::bar_arrive(&r.empty[prev]);
    }
    hopper::wgmma_wait<0>();
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      hopper::wgmma_64<0, 0>(p1, hopper::desc_k(a, ks),
                             hopper::desc_k(b + hopper::kBoxBytes, ks),
                             ks > 0);
    hopper::wgmma_commit();
    promote<0>(acc, p0, kb == 0);
    prev = c.stage;
    c.next(kLogitStages);
  }
  hopper::wgmma_wait<0>();
  promote<32>(acc, p1, nk == 1);
  if (signal) hopper::bar_arrive(&r.empty[prev]);
}

// Column (within the 128-wide tile) of accumulator register i of this
// thread, and its row (within the warpgroup's 64) for half hf = (i/2) % 2.
__device__ __forceinline__ int frag_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
}
__device__ __forceinline__ int frag_row(int hf, int warp, int lane) {
  return 16 * (warp & 3) + lane / 4 + 8 * hf;
}

}  // namespace tc
