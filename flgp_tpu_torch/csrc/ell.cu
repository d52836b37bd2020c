// K5: the eigenvector extension on the point-major (n, r) ELL layout.
//
// Replaces the TPU kernel in flgp_tpu/ops/pallas_kernels.py:
//   K5 ell_norm_matmat  (_ell_norm_matmat_kernel) Zn @ W
// with Zn = rownorm(Z diag(cscale)): w1 = w * cscale[idx], wn = w1 / (sum w1 + eps)
// (normalized_point, common.cuh, shared with K4 and K6-K8 in ell_t.cu; K3
// and K4 run through the bodies of K6 and K7 there, as the chunked layout
// with c = 1).
//
// What bounds it on the H100: the (n, K) output writes and the gathered
// reads of W rows (r * K floats per row, L2-resident for s * K <= a few MB);
// the compact graph is 8 bytes per nonzero (24 MB at n = 1e6, r = 3).
//
// Design: the TPU kernel recast the gather as a one-hot matmul because
// Mosaic has none; Hopper gathers natively, so one warp per row: every lane
// recomputes the row's r normalized weights, lanes stride the K output
// columns, so the W reads and the output writes of a warp are contiguous.
// No atomics: deterministic.  Indices outside [0, s) contribute nothing
// (knn never produces them; the guard keeps a bad input from reading out of
// bounds), nor do zero weights.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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
