// K2's kernel body and launcher, shared by lae.cu (the exact variant and
// the C entry points) and lae_fused.cu (the fused variant): two translation
// units, so that nvcc compiles the 16 fan-ins of each variant side by side.
// The design is described in lae.cu.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace flgp_k2 {

constexpr int kThreads = 128;

// x / M for a compile-time integer M >= 1, correctly rounded (round to
// nearest even) for x = 0 and 2^-60 <= |x| <= 2^60: q0 = RN(x * RN(1/M)) is
// within one ulp of x/M, the residual e = x - M*q0 is exact in one fmaf, and
// RN(q0 + e * RN(1/M)) is then the rounded quotient (x = -0 gives +0: equal
// in value).  In the projection x = css - 1 is 0 or at least 2^-24 in
// magnitude.
template <int M>
__device__ __forceinline__ float div_const(float x) {
  constexpr float m = static_cast<float>(M);
  constexpr float y = 1.0f / m;
  if constexpr ((M & (M - 1)) == 0) {
    return __fmul_rn(x, y);
  } else {
    const float q0 = __fmul_rn(x, y);
    const float e = __fmaf_rn(-m, q0, x);
    return __fmaf_rn(e, y, q0);
  }
}

// q[K] = (css[K] - 1)/(K + 1) for K = 1 .. R-1, K a compile-time constant
template <int R, int K = 1>
__device__ __forceinline__ void simplex_quotients(const float (&css)[R], float (&q)[R]) {
  if constexpr (K < R) {
    q[K] = div_const<K + 1>(__fadd_rn(css[K], -1.0f));
    simplex_quotients<R, K + 1>(css, q);
  }
}

template <int R, bool FUSED>
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
  float css[R];
  css[0] = u[0];
#pragma unroll
  for (int k = 1; k < R; ++k) css[k] = __fadd_rn(css[k - 1], u[k]);
  // rho = 1 + the number of k >= 1 with u_k > (css_k - 1)/(k + 1) (a count,
  // as the plain version takes it); theta = (css_rho - 1)/rho
  float theta;
  int more = 0;
  if constexpr (FUSED) {
    float x[R];
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = css[k] - 1.0f;
#pragma unroll
    for (int k = 1; k < R; ++k) more += (u[k] * (k + 1.0f) > x[k]) ? 1 : 0;
    float xr = x[0], yr = 1.0f;
#pragma unroll
    for (int k = 1; k < R; ++k) {
      xr = (more == k) ? x[k] : xr;
      yr = (more == k) ? 1.0f / (k + 1.0f) : yr;
    }
    theta = xr * yr;
  } else {
    float q[R];
    q[0] = __fadd_rn(css[0], -1.0f);
    simplex_quotients<R>(css, q);
#pragma unroll
    for (int k = 1; k < R; ++k) more += (u[k] > q[k]) ? 1 : 0;   // u - q > 0, no flush to zero
    theta = q[0];
#pragma unroll
    for (int k = 1; k < R; ++k) theta = (more == k) ? q[k] : theta;
  }
#pragma unroll
  for (int a = 0; a < R; ++a) z[a] = fmaxf(__fadd_rn(w[a], -theta), 0.0f);
}

// index of entry (a, e) = (e, a) in the packed upper triangle of an R x R matrix
template <int R>
__device__ __forceinline__ constexpr int tri(int a, int e) {
  const int lo = a < e ? a : e, hi = a < e ? e : a;
  return lo * R - lo * (lo - 1) / 2 + (hi - lo);
}

// X: the cloud, coordinate k of point p at X[p*xs_p + k*xs_k].  idx, out:
// (nch, R, c) with nch*c = npts >= n; U (s, d) row-major; alpha_tab (iters,).
template <int R, bool FUSED>
__global__ void __launch_bounds__(kThreads)
lae_kernel(const float* __restrict__ X, long long xs_p, long long xs_k,
           const float* __restrict__ U, const int* __restrict__ idx, long long n,
           long long npts, int c, int s, int d, int iters,
           const float* __restrict__ alpha_tab, float* __restrict__ out) {
  extern __shared__ float alpha_s[];
  for (int i = threadIdx.x; i < iters; i += blockDim.x) alpha_s[i] = alpha_tab[i];
  __syncthreads();

  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const size_t base = static_cast<size_t>(p / c) * R * c + static_cast<size_t>(p % c);
  if (p >= n) {  // a pad point of the last chunk
#pragma unroll
    for (int a = 0; a < R; ++a) out[base + static_cast<size_t>(a) * c] = 0.0f;
    return;
  }

  int ia[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int j = idx[base + static_cast<size_t>(a) * c];
    ia[a] = (j >= 0 && j < s) ? j : 0;  // indices come from knn; guard the gather
  }

  // G is symmetric bit for bit (the same products summed in the same order),
  // so only its upper triangle is kept: r(r+1)/2 registers instead of r^2
  float G[R * (R + 1) / 2];
  float b[R];
  const float* x = X + p * xs_p;
  for (int k = 0; k < d; ++k) {
    const float xk = x[k * xs_k];
    float u[R];
#pragma unroll
    for (int a = 0; a < R; ++a) u[a] = U[static_cast<size_t>(ia[a]) * d + k];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const float pb = __fmul_rn(xk, u[a]);
      b[a] = (k == 0) ? pb : __fadd_rn(b[a], pb);
#pragma unroll
      for (int e = a; e < R; ++e) {
        const float pg = __fmul_rn(u[a], u[e]);
        G[tri<R>(a, e)] = (k == 0) ? pg : __fadd_rn(G[tri<R>(a, e)], pg);
      }
    }
  }

  // Gershgorin bound on lambda_max(G) -> fixed step 1/L
  float L = 0.0f;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    float rowsum = fabsf(G[tri<R>(a, 0)]);
#pragma unroll
    for (int e = 1; e < R; ++e) rowsum = __fadd_rn(rowsum, fabsf(G[tri<R>(a, e)]));
    L = fmaxf(L, rowsum);
  }
  const float inv_L = 1.0f / (L + 1e-12f);

  float z[R], z_prev[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    z[a] = 1.0f / R;
    z_prev[a] = z[a];
  }
#pragma unroll 2
  for (int it = 0; it < iters; ++it) {
    const float alpha = alpha_s[it];
    float v[R], w[R];
    if constexpr (FUSED) {
#pragma unroll
      for (int a = 0; a < R; ++a) v[a] = fmaf(alpha, z[a] - z_prev[a], z[a]);
#pragma unroll
      for (int e = 0; e < R; ++e) {
        float g = -b[e];
#pragma unroll
        for (int a = 0; a < R; ++a) g = fmaf(v[a], G[tri<R>(a, e)], g);
        w[e] = fmaf(-inv_L, g, v[e]);
      }
    } else {
#pragma unroll
      for (int a = 0; a < R; ++a)
        v[a] = __fadd_rn(z[a], __fmul_rn(alpha, __fadd_rn(z[a], -z_prev[a])));
#pragma unroll
      for (int e = 0; e < R; ++e) {
        float g = __fmul_rn(v[0], G[tri<R>(0, e)]);
#pragma unroll
        for (int a = 1; a < R; ++a) g = __fadd_rn(g, __fmul_rn(v[a], G[tri<R>(a, e)]));
        w[e] = __fadd_rn(v[e], -__fmul_rn(inv_L, __fadd_rn(g, -b[e])));
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) z_prev[a] = z[a];
    project_simplex<R, FUSED>(w, z);
  }

#pragma unroll
  for (int a = 0; a < R; ++a) out[base + static_cast<size_t>(a) * c] = z[a];
}

// one launch of K2; the fields as the arguments of flgp_lae (lae.cu)
struct Args {
  const float* X;
  long long xs_p, xs_k;
  const float* U;
  const int* idx;
  long long n, npts;
  int c, s, d, r, iters;
  const float* alpha;
  float* out;
  cudaStream_t stream;
};

template <bool FUSED>
int launch(const Args& a) {
  const dim3 grid(static_cast<unsigned>((a.npts + kThreads - 1) / kThreads));
  const size_t smem = static_cast<size_t>(a.iters) * sizeof(float);
  switch (a.r) {
#define FLGP_LAE_CASE(R)                                                                       \
  case R:                                                                                      \
    lae_kernel<R, FUSED><<<grid, kThreads, smem, a.stream>>>(                                  \
        a.X, a.xs_p, a.xs_k, a.U, a.idx, a.n, a.npts, a.c, a.s, a.d, a.iters, a.alpha, a.out); \
    break;
    FLGP_R_CASES(FLGP_LAE_CASE)
#undef FLGP_LAE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_fused(const Args& a);  // launch<true>, compiled in lae_fused.cu

}  // namespace flgp_k2
