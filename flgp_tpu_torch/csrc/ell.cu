// K3-K5: the spectral-stage graph tail on the (n, r) ELL layout.
//
// Replaces the TPU kernels in flgp_tpu/ops/pallas_kernels.py:
//   K3 ell_colsum       (_ell_colsum_kernel)      C = colsum(Z)
//   K4 ell_norm_gram    (_ell_norm_gram_kernel)   G = Zn^T Zn, D = colsum(Zn)
//   K5 ell_norm_matmat  (_ell_norm_matmat_kernel) Zn @ W
// with Zn = rownorm(Z diag(cscale)): w1 = w * cscale[idx], wn = w1 / (sum w1 + eps).
//
// What bounds them on the H100: each is one pass over the compact graph
// (8 bytes per nonzero; 24 MB at n = 1e6, r = 3), so memory traffic is a
// few microseconds; K3 and K4 are bound by atomic throughput into an (s,)
// or (s, s) target that stays in the 50 MB L2, K5 by the gathered reads of
// W rows (r * K floats per row, L2-resident for s * K <= a few MB).
//
// Design: the TPU kernels recast every gather and scatter as a one-hot
// matmul because Mosaic has neither; Hopper has native gathers and float
// atomics, so:
//   K3: a grid-stride atomicAdd of the n*r values into a zeroed (s,) buffer.
//   K4: one thread per row; gather cscale, row-normalize in registers, then
//       atomicAdd D[idx_a] += wn_a and G[idx_a, idx_b] += wn_a * wn_b for all
//       r^2 pairs (equal to dense^T dense, duplicate indices included).
//   K5: one warp per row; every lane recomputes the row's r normalized
//       weights, lanes stride the K output columns, so the W reads of a warp
//       are contiguous.  No atomics: deterministic.
// Atomic sums reorder additions from run to run; compare with tolerances.
// Indices outside [0, s) contribute nothing (knn never produces them; the
// guard keeps a bad input from writing out of bounds), nor do zero weights.
// The row normalization (normalized_point) is shared with K6-K8 in
// common.cuh.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void ell_colsum_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                                  long long nnz, int s, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < nnz;
       e += stride) {
    const int c = idx[e];
    if (c >= 0 && c < s) atomicAdd(out + c, vals[e]);
  }
}

template <int R>
__global__ void ell_norm_gram_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                                     const float* __restrict__ cscale, int n, int s, float eps,
                                     float* __restrict__ G, float* __restrict__ D) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int c[R];
  float w[R];
  normalized_point<R>(vals, idx, cscale, static_cast<size_t>(row) * R, 1, s, eps, c, w);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    if (c[a] < 0) continue;
    atomicAdd(D + c[a], w[a]);
    float* grow = G + static_cast<size_t>(c[a]) * s;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      if (c[b] >= 0) atomicAdd(grow + c[b], w[a] * w[b]);
    }
  }
}

template <int R>
__global__ void ell_norm_matmat_kernel(const float* __restrict__ vals,
                                       const int* __restrict__ idx,
                                       const float* __restrict__ cscale,
                                       const float* __restrict__ W, int n, int s, int K,
                                       float eps, float* __restrict__ out) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;
  const int row = static_cast<int>(warp);
  int c[R];
  float w[R];
  normalized_point<R>(vals, idx, cscale, static_cast<size_t>(row) * R, 1, s, eps, c, w);
  for (int k = lane; k < K; k += 32) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < R; ++a) {
      if (c[a] >= 0) acc = fmaf(w[a], W[static_cast<size_t>(c[a]) * K + k], acc);
    }
    out[static_cast<size_t>(row) * K + k] = acc;
  }
}

}  // namespace

// vals, idx: nnz entries (f32, i32); out (s,) f32, zeroed by the caller.
extern "C" int flgp_ell_colsum(const void* vals, const void* idx, long long nnz, int s,
                               void* out, void* stream) {
  if (nnz <= 0) return static_cast<int>(cudaSuccess);
  long long blocks = (nnz + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  ell_colsum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx), nnz, s,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// vals, idx (n, r); cscale (s,) -> G (s, s), D (s,), both zeroed by the caller.
extern "C" int flgp_ell_norm_gram(const void* vals, const void* idx, const void* cscale, int n,
                                  int r, int s, float eps, void* G, void* D, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* ii = static_cast<const int*>(idx);
  const float* cs = static_cast<const float*>(cscale);
  float* g = static_cast<float*>(G);
  float* dd = static_cast<float*>(D);
  switch (r) {
#define FLGP_GRAM_CASE(R)                                                              \
  case R:                                                                              \
    ell_norm_gram_kernel<R><<<grid, kThreads, 0, st>>>(v, ii, cs, n, s, eps, g, dd);   \
    break;
    FLGP_R_CASES(FLGP_GRAM_CASE)
#undef FLGP_GRAM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals, idx (n, r); cscale (s,); W (s, K) -> out (n, K).
extern "C" int flgp_ell_norm_matmat(const void* vals, const void* idx, const void* cscale,
                                    const void* W, int n, int r, int s, int K, float eps,
                                    void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int rows_per_block = kThreads / 32;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* ii = static_cast<const int*>(idx);
  const float* cs = static_cast<const float*>(cscale);
  const float* w = static_cast<const float*>(W);
  float* o = static_cast<float*>(out);
  switch (r) {
#define FLGP_MATMAT_CASE(R)                                                              \
  case R:                                                                                \
    ell_norm_matmat_kernel<R><<<grid, kThreads, 0, st>>>(v, ii, cs, w, n, s, K, eps, o); \
    break;
    FLGP_R_CASES(FLGP_MATMAT_CASE)
#undef FLGP_MATMAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
