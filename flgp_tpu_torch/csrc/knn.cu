// K1: brute-force r-nearest-anchor search.
//
// Replaces the TPU kernel flgp_tpu/ops/pallas_kernels.py:fused_knn
// (_knn_kernel): d = |x|^2 - 2 x.u + |u|^2 at full f32, then the r smallest
// per row, nearest first, ties to the lowest anchor index.
//
// What bounds it on the H100: at the main path's shapes (d = 2, s <= 2049)
// each row costs s*(d FMAs + one compare) and the inputs are a few MB, so
// the kernel is bound by issue rate of the per-anchor loop, not by memory.
// The TPU kernel formed the (block, s) distance tile in VMEM and ran r
// masked row-min passes over it; here no tile exists at all.
//
// Design: one thread per row of X.  Anchors stream through shared memory in
// tiles (any s works), every thread of the block reads the same anchor at
// the same time (a broadcast, no bank conflicts), and each thread keeps a
// sorted top-r list in registers (r is a template parameter, at most 16).
// Anchors are scanned in increasing index order and a candidate displaces a
// list entry only if it is lexicographically smaller in (d^2, index), so
// ties keep the lower index.
//
// Rounding follows the plain version (ops/distance.py:sqdist) step by step
// so that near-ties break the same way: the norms are sums of rounded
// squares (no FMA contraction, as torch.sum(X * X) rounds each product), the
// cross term an FMA chain over the features, as a GEMM accumulates.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
// floats of shared memory per tile: anchors (tile x d) plus their norms
constexpr int kTileFloats = 8192;

template <int R>
__global__ void knn_kernel(const float* __restrict__ X, const float* __restrict__ U,
                           int n, int s, int d, int tile,
                           int* __restrict__ idx_out, float* __restrict__ dist_out) {
  extern __shared__ float smem[];
  float* us = smem;                             // tile * d anchor coordinates
  float* u2s = smem + static_cast<size_t>(tile) * d;  // tile anchor norms

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;
  const float* x = X + static_cast<size_t>(live ? row : 0) * d;

  float x2 = 0.0f;
  if (live) {
    for (int k = 0; k < d; ++k) x2 = __fadd_rn(x2, __fmul_rn(x[k], x[k]));
  }

  float bd[R];
  int bi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    bd[k] = CUDART_INF_F;
    bi[k] = INT_MAX;
  }

  for (int t0 = 0; t0 < s; t0 += tile) {
    const int cnt = min(tile, s - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = threadIdx.x; e < cnt * d; e += blockDim.x) {
      us[e] = U[static_cast<size_t>(t0) * d + e];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      float acc = 0.0f;
      for (int k = 0; k < d; ++k) acc = __fadd_rn(acc, __fmul_rn(us[j * d + k], us[j * d + k]));
      u2s[j] = acc;
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        float dot = 0.0f;
        for (int k = 0; k < d; ++k) dot = fmaf(x[k], us[j * d + k], dot);
        const float dist = (x2 - 2.0f * dot) + u2s[j];
        if (dist < bd[R - 1]) {
          float cd = dist;
          int ci = t0 + j;
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const bool smaller = cd < bd[k] || (cd == bd[k] && ci < bi[k]);
            if (smaller) {
              const float td = bd[k];
              const int ti = bi[k];
              bd[k] = cd;
              bi[k] = ci;
              cd = td;
              ci = ti;
            }
          }
        }
      }
    }
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      idx_out[static_cast<size_t>(row) * R + k] = bi[k];
      dist_out[static_cast<size_t>(row) * R + k] = bd[k];
    }
  }
}

}  // namespace

// X (n, d) f32, U (s, d) f32 -> idx (n, r) i32, dist (n, r) f32; 1 <= r <= 16.
extern "C" int flgp_knn(const void* X, const void* U, int n, int s, int d, int r,
                        void* idx, void* dist, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int tile = std::max(1, kTileFloats / (d + 1));
  const size_t smem = static_cast<size_t>(tile) * (d + 1) * sizeof(float);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* Uf = static_cast<const float*>(U);
  int* io = static_cast<int*>(idx);
  float* dout = static_cast<float*>(dist);
  switch (r) {
#define FLGP_KNN_CASE(R)                                                         \
  case R:                                                                        \
    knn_kernel<R><<<grid, kThreads, smem, st>>>(Xf, Uf, n, s, d, tile, io, dout); \
    break;
    FLGP_R_CASES(FLGP_KNN_CASE)
#undef FLGP_KNN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
