// K1's kernels, shared by knn.cu (the pre-pass and the C entry point),
// knn_d2.cu / knn_d3.cu (the bodies with d a template
// parameter), knn_tiled.cu (the tiled body for every other d) and
// knn_wide.cu (the run-time-r body: every r above 16, any d), one source
// each so that nvcc builds them side by side.  The design notes are at the
// top of knn.cu, knn_tiled.cu and knn_wide.cu.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace flgp_k1 {

constexpr int kThreads = 128;
// shared memory of one anchor tile: 2048 16-byte records at d = 2 or 3
constexpr int kTileBytes = 32768;

struct Args {
  const float* X;   // (n, d) rows
  const float* P;   // packed anchors, see knn_pack_kernel
  int n, s, d, r;
  int split;        // lanes that share a row and divide the anchors: 1, 2, ..., 32
                    // (the tiled body: blocks that divide a row block's anchors)
  float* part;      // the tiled and run-time-r bodies' split lists, 2 * split * n * r words
                    // (split > 1)
  float* lists;     // the run-time-r body's merge temps where they leave shared memory
                    // (flgp_knn_wide_lists words)
  int* idx;         // (n, r)
  float* dist;      // (n, r)
  cudaStream_t stream;
};

// Rows a thread owns: every anchor record read from shared memory serves
// this many rows, and their FMA chains overlap.  The top-r lists are
// 2 * R * rows registers, so wide lists take fewer rows.
__host__ __device__ constexpr int rows_per_thread(int r) { return r <= 8 ? 4 : 2; }

// Floats a packed anchor record takes in the tiled body: d + 1 rounded up to
// a multiple of 4, so that every record starts 16-byte aligned.
__host__ __device__ constexpr int tiled_rec(int d) { return (d + 4) & ~3; }

template <int R>
__device__ __forceinline__ void topr_init(float (&bd)[R], int (&bi)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    bd[k] = CUDART_INF_F;
    bi[k] = INT_MAX;
  }
}

// Insert (cd, ci) into a list sorted by (d^2, index): one bubble pass of
// predicated swaps, no branch (with one or two lanes of a warp here at a
// time, branches that end the pass early cost more than they save: a
// back-to-front insertion with an early exit measured slower).  LEX = false compares d^2
// alone, for a thread's own scan: it meets its anchors in increasing index
// order, so on equal d^2 the candidate's index is the higher one and it stays
// behind.
template <int R, bool LEX>
__device__ __forceinline__ void topr_insert(float (&bd)[R], int (&bi)[R], float cd, int ci) {
  bool smaller = false;  // once the candidate has its place, every later entry moves down
#pragma unroll
  for (int k = 0; k < R; ++k) {
    smaller = smaller || cd < bd[k] || (LEX && cd == bd[k] && ci < bi[k]);
    const float td = bd[k];
    const int ti = bi[k];
    bd[k] = smaller ? cd : td;
    bi[k] = smaller ? ci : ti;
    cd = smaller ? td : cd;
    ci = smaller ? ti : ci;
  }
}

// The `split` lanes that share a thread's rows (neighbouring lanes of one
// warp) each hold the top-r list of their part of the anchors.  A butterfly
// of shuffles merges them: both partners take the other's list as it was
// before the step, entry by entry from a copy that shifts up, and insert it
// into their own, so after log2(split) steps every lane holds the top-r of
// all anchors in (d^2, index) order -- the list a single scan gives.  Lane 0
// of the group writes it.  The entry loop is not unrolled: the merge runs
// once a thread, and r^2 copies of the insertion would be most of the build.
template <int R, int ROWS>
__device__ __forceinline__ void merge_and_store(float (&bd)[ROWS][R], int (&bi)[ROWS][R],
                                                int split, int sub,
                                                const long long (&row)[ROWS], int n,
                                                int* __restrict__ idx_out,
                                                float* __restrict__ dist_out) {
  for (int m = 1; m < split; m <<= 1) {
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      float od[R];
      int oi[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        od[k] = bd[q][k];
        oi[k] = bi[q][k];
      }
#pragma unroll 1
      for (int k = 0; k < R; ++k) {
        const float cd = __shfl_xor_sync(0xffffffffu, od[0], m);
        const int ci = __shfl_xor_sync(0xffffffffu, oi[0], m);
        if (cd < bd[q][R - 1] || (cd == bd[q][R - 1] && ci < bi[q][R - 1])) {
          topr_insert<R, true>(bd[q], bi[q], cd, ci);
        }
#pragma unroll
        for (int i = 0; i + 1 < R; ++i) {
          od[i] = od[i + 1];
          oi[i] = oi[i + 1];
        }
      }
    }
  }
  if (sub != 0) return;
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    if (row[q] < n) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        idx_out[static_cast<size_t>(row[q]) * R + k] = bi[q][k];
        dist_out[static_cast<size_t>(row[q]) * R + k] = bd[q][k];
      }
    }
  }
}

// d = D at compile time (2 or 3).  P holds one float4 per anchor:
// (-2u_0, -2u_1, -2u_2 or 0, |u|^2).  A thread keeps ROWS rows of X and
// their norms in registers; one 16-byte shared-memory read per anchor, the
// same address in every lane of a group, serves all of them.
template <int R, int D>
__global__ void __launch_bounds__(kThreads)
knn_fixed_kernel(const float* __restrict__ X, const float4* __restrict__ P, int n, int s,
                 int split, int* __restrict__ idx_out, float* __restrict__ dist_out) {
  constexpr int ROWS = rows_per_thread(R);
  constexpr int kTile = kTileBytes / static_cast<int>(sizeof(float4));
  extern __shared__ __align__(16) unsigned char knn_smem[];
  float4* tile = reinterpret_cast<float4*>(knn_smem);

  const int sub = threadIdx.x & (split - 1);
  const int slots = kThreads / split;
  const int slot = threadIdx.x / split;
  const long long base = static_cast<long long>(blockIdx.x) * slots * ROWS;

  long long row[ROWS];
  float x[ROWS][D], x2[ROWS];
  float bd[ROWS][R];
  int bi[ROWS][R];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    row[q] = base + static_cast<long long>(q) * slots + slot;
    const float* xr = X + static_cast<size_t>(row[q] < n ? row[q] : 0) * D;
    x2[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      x[q][k] = xr[k];
      x2[q] = __fadd_rn(x2[q], __fmul_rn(x[q][k], x[q][k]));
    }
    topr_init<R>(bd[q], bi[q]);
  }

  for (int t0 = 0; t0 < s; t0 += kTile) {
    const int cnt = min(kTile, s - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = threadIdx.x; e < cnt; e += kThreads) tile[e] = P[t0 + e];
    __syncthreads();
    for (int j = sub; j < cnt; j += split) {
      const float4 a = tile[j];
      float dist[ROWS];
      bool any = false;
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        // -2 x.u as the plain version's dot product rounds it, times -2 (exact)
        float m = __fmul_rn(x[q][0], a.x);
        m = fmaf(x[q][1], a.y, m);
        if constexpr (D == 3) m = fmaf(x[q][2], a.z, m);
        dist[q] = __fadd_rn(__fadd_rn(x2[q], m), a.w);
        any |= dist[q] < bd[q][R - 1];
      }
      if (any) {  // one branch an anchor; rare after the first anchors
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
          if (dist[q] < bd[q][R - 1]) topr_insert<R, false>(bd[q], bi[q], dist[q], t0 + j);
        }
      }
    }
  }
  merge_and_store<R, ROWS>(bd, bi, split, sub, row, n, idx_out, dist_out);
}

template <int D>
int launch_fixed(const Args& a) {
  const int tile = std::min(a.s, kTileBytes / static_cast<int>(sizeof(float4)));
  const size_t smem = static_cast<size_t>(tile) * sizeof(float4);
  const float4* P4 = reinterpret_cast<const float4*>(a.P);
  switch (a.r) {
#define FLGP_KNN_CASE(R)                                                                    \
  case R: {                                                                                 \
    const int rows = (kThreads / a.split) * rows_per_thread(R);                            \
    knn_fixed_kernel<R, D><<<(a.n + rows - 1) / rows, kThreads, smem, a.stream>>>(          \
        a.X, P4, a.n, a.s, a.split, a.idx, a.dist);                                         \
    break;                                                                                  \
  }
    FLGP_R_CASES(FLGP_KNN_CASE)
#undef FLGP_KNN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// defined in knn_d2.cu, knn_d3.cu, knn_tiled.cu and knn_wide.cu
int launch_d2(const Args& a);
int launch_d3(const Args& a);
int launch_tiled(const Args& a);
int launch_wide(const Args& a);

}  // namespace flgp_k1
