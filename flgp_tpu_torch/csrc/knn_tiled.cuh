// K1's register-tiled product, shared by the tiled body (knn_tiled.cu,
// every d but 2 and 3 at r <= 16) and the run-time-r body (knn_wide.cu, every
// d at any r): the block's shape, the asynchronous copies that fill its
// feature slabs and the FMA chains over one slab.  knn_tiled.cu has the
// design notes.
#pragma once

#include "knn.cuh"

namespace flgp_k1 {
namespace {

constexpr int kTiledThreads = 256;
constexpr int kTM = 4;                       // rows of a thread's tile of dot products
constexpr int kTN = 8;                       // anchors of it
constexpr int kBM = 16 * kTM;                // rows a block: 16 row groups
constexpr int kBN = 16 * kTN;                // anchors a tile: 16 anchor groups
constexpr int kBK = 16;                      // features a slab
constexpr int kStages = 3;                   // slabs in shared memory: one used, two loading
constexpr int kLDS = kBK + 4;                // a slab row: 80 bytes, see fma_slab
constexpr int kLDD = kBN + 8;                // a d^2 row: see the epilogue and the selection
constexpr int kLanesARow = kTiledThreads / kBM;      // selection threads that share a row
constexpr int kMergeThreads = 256;
// shared memory a block: the slabs of X and of the anchors, the tiles'
// |u|^2, a tile's d^2, the rows' |x|^2
constexpr size_t kSmemBytes =
    sizeof(float) * (kStages * ((kBM + kBN) * kLDS + kBN) + kBM * kLDD + kBM);
static_assert(kBM * kBK / 4 == kTiledThreads, "one 16-byte copy of X a thread a slab");
static_assert(kBN * kBK / 4 == 2 * kTiledThreads, "two of the anchors");
static_assert(kBN == kLanesARow * 32, "a selection lane takes 32 anchors a tile");

// Copies from global to shared memory, asynchronous: 16 bytes of which the
// first `bytes` are read and the rest written 0 (16-byte aligned ends), or
// 4 bytes, none read and 0 written unless ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sdst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sdst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `kn` features of a slab (row-major, kLDS floats a row) into the thread's
// chains: rows ty + 16q, anchors tx + 16c.  Per 4 features a 16-byte read
// of each row and each anchor, then the 4 features in order.  In a warp the
// rows are 4 neighbours and the anchors 8, 80 bytes apart: distinct
// 16-byte bank groups, so every read is one wavefront.
template <bool FULL>
__device__ __forceinline__ void fma_slab(const float* xrows, const float* arows, int kn,
                                         float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int kb = 0; kb < kBK; kb += 4) {
    if (!FULL && kb >= kn) break;
    float4 xv[kTM], av[kTN];
#pragma unroll
    for (int q = 0; q < kTM; ++q)
      xv[q] = *reinterpret_cast<const float4*>(xrows + 16 * q * kLDS + kb);
#pragma unroll
    for (int c = 0; c < kTN; ++c)
      av[c] = *reinterpret_cast<const float4*>(arows + 16 * c * kLDS + kb);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!FULL && kb + k >= kn) break;
#pragma unroll
      for (int q = 0; q < kTM; ++q) {
        const float x = k == 0 ? xv[q].x : k == 1 ? xv[q].y : k == 2 ? xv[q].z : xv[q].w;
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          const float u = k == 0 ? av[c].x : k == 1 ? av[c].y : k == 2 ? av[c].z : av[c].w;
          acc[q][c] = fmaf(x, u, acc[q][c]);
        }
      }
    }
  }
}

}  // namespace
}  // namespace flgp_k1
