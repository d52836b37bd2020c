// K2: local anchor embedding weights by fixed-iteration FISTA.
//
// Replaces the TPU kernel flgp_tpu/ops/pallas_kernels.py:fused_lae_tiles
// (_lae_fista_kernel), together with the XLA Gram assembly that feeds it
// (assemble_lae_gram_t).  Per point i, with U_i its r nearest anchors:
// G = U_i U_i^T, b = U_i x, then `iters` FISTA steps from z = 1/r with step
// 1/L, L = max row-abs-sum of G + 1e-12, momentum d' = (1 + sqrt(1+4d^2))/2,
// each step projected onto the probability simplex.
//
// What bounds it on the H100: per point ~iters * (r^2 + r log r) flops on
// data that fits in registers, against r*d + d + r floats read and r written
// once.  It is compute (issue) bound; under plain PyTorch the same loop is
// ~15 launches per iteration, each a full pass over (n, r) arrays.
//
// Design: one thread per point.  The thread gathers its r anchor rows
// itself, forms G and b in registers (no (n, r, r) array is written), runs
// every iteration in registers and writes its r weights once, row-major
// (n, r) like the plain version.  The simplex projection sorts the r values
// with an odd-even transposition network (fully unrolled, no data-dependent
// branches) and picks theta from the running cumulative sum, as the plain
// version does.  The TPU
// kernel's (r, n) lane-packed layout existed to fill 128-wide vector lanes
// and is not carried over.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int R>
__device__ __forceinline__ void project_simplex(const float (&w)[R], float (&z)[R]) {
  float u[R];
#pragma unroll
  for (int a = 0; a < R; ++a) u[a] = w[a];
  // descending odd-even transposition sort
#pragma unroll
  for (int p = 0; p < R; ++p) {
#pragma unroll
    for (int i = p % 2; i < R - 1; i += 2) {
      const float hi = fmaxf(u[i], u[i + 1]);
      const float lo = fminf(u[i], u[i + 1]);
      u[i] = hi;
      u[i + 1] = lo;
    }
  }
  // rho = number of k with u_k > (css_k - 1)/k, theta = (css_rho - 1)/rho
  float css[R];
  css[0] = u[0];
#pragma unroll
  for (int k = 1; k < R; ++k) css[k] = css[k - 1] + u[k];
  int rho = 0;
#pragma unroll
  for (int k = 0; k < R; ++k) rho += (u[k] - (css[k] - 1.0f) / (k + 1.0f) > 0.0f) ? 1 : 0;
  rho = max(rho, 1);
  float css_rho = css[0];
#pragma unroll
  for (int k = 1; k < R; ++k) css_rho = (k == rho - 1) ? css[k] : css_rho;
  const float theta = (css_rho - 1.0f) / static_cast<float>(rho);
#pragma unroll
  for (int a = 0; a < R; ++a) z[a] = fmaxf(w[a] - theta, 0.0f);
}

// Every product is rounded on its own and every sum runs in the plain
// version's order (ops/lae.py:lae_weights_plain): __fmul_rn/__fadd_rn keep
// nvcc from contracting a*b+c into one FMA.  With nearly collinear anchors
// the problem is ill-conditioned and 150 steps leave the iterate sensitive
// to rounding, so matching the order is what keeps the two versions close.
template <int R>
__global__ void lae_kernel(const float* __restrict__ X, const float* __restrict__ U,
                           const int* __restrict__ idx, int n, int s, int d, int iters,
                           float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;

  int ia[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int c = idx[static_cast<size_t>(row) * R + a];
    ia[a] = (c >= 0 && c < s) ? c : 0;  // indices come from knn; guard the gather
  }

  float G[R][R];
  float b[R];
  const float* x = X + static_cast<size_t>(row) * d;
  for (int k = 0; k < d; ++k) {
    const float xk = x[k];
    float u[R];
#pragma unroll
    for (int a = 0; a < R; ++a) u[a] = U[static_cast<size_t>(ia[a]) * d + k];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const float pb = __fmul_rn(xk, u[a]);
      b[a] = (k == 0) ? pb : __fadd_rn(b[a], pb);
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float pg = __fmul_rn(u[a], u[c]);
        G[a][c] = (k == 0) ? pg : __fadd_rn(G[a][c], pg);
      }
    }
  }

  // Gershgorin bound on lambda_max(G) -> fixed step 1/L
  float L = 0.0f;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    float rowsum = fabsf(G[a][0]);
#pragma unroll
    for (int c = 1; c < R; ++c) rowsum = __fadd_rn(rowsum, fabsf(G[a][c]));
    L = fmaxf(L, rowsum);
  }
  const float inv_L = 1.0f / (L + 1e-12f);

  float z[R], z_prev[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    z[a] = 1.0f / R;
    z_prev[a] = z[a];
  }
  float d_prev = 0.0f, d_curr = 1.0f;
  for (int it = 0; it < iters; ++it) {
    const float alpha = (d_prev - 1.0f) / d_curr;
    float v[R], w[R];
#pragma unroll
    for (int a = 0; a < R; ++a) v[a] = __fadd_rn(z[a], __fmul_rn(alpha, z[a] - z_prev[a]));
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float g = __fmul_rn(v[0], G[0][c]);
#pragma unroll
      for (int a = 1; a < R; ++a) g = __fadd_rn(g, __fmul_rn(v[a], G[a][c]));
      w[c] = __fsub_rn(v[c], __fmul_rn(inv_L, g - b[c]));
    }
#pragma unroll
    for (int a = 0; a < R; ++a) z_prev[a] = z[a];
    project_simplex<R>(w, z);
    const float d_next =
        (1.0f + sqrtf(__fadd_rn(1.0f, __fmul_rn(4.0f * d_curr, d_curr)))) / 2.0f;
    d_prev = d_curr;
    d_curr = d_next;
  }

#pragma unroll
  for (int a = 0; a < R; ++a) out[static_cast<size_t>(row) * R + a] = z[a];
}

}  // namespace

// X (n, d) f32, U (s, d) f32, idx (n, r) i32 -> out (n, r) f32; 1 <= r <= 16.
extern "C" int flgp_lae(const void* X, const void* U, const void* idx, int n, int s, int d,
                        int r, int iters, void* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* Xf = static_cast<const float*>(X);
  const float* Uf = static_cast<const float*>(U);
  const int* ii = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  switch (r) {
#define FLGP_LAE_CASE(R)                                                        \
  case R:                                                                       \
    lae_kernel<R><<<grid, kThreads, 0, st>>>(Xf, Uf, ii, n, s, d, iters, o);    \
    break;
    FLGP_R_CASES(FLGP_LAE_CASE)
#undef FLGP_LAE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
