// Shared by the kernel sources: the fan-in values the kernels are
// instantiated for.  A kernel keeps r values per row in registers, so r is a
// template parameter; the C entry points switch on it with this list.
#pragma once

#include <cstddef>

#define FLGP_R_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// Row-normalized weights of one point of an ELL graph whose R entries sit at
// base, base + stride, ..., base + (R-1)*stride: stride 1 for the point-major
// (n, r) layout, c for the chunked feature-major (nch, r, c) one.
//   w1 = vals * cscale[idx],  w = w1 / (sum w1 + eps).
// An entry with an out-of-range index or a zero scaled weight gets weight 0
// and index -1, so callers skip it: it adds exactly nothing to any sum.
template <int R>
__device__ __forceinline__ void normalized_point(const float* __restrict__ vals,
                                                 const int* __restrict__ idx,
                                                 const float* __restrict__ cscale, size_t base,
                                                 size_t stride, int s, float eps, int (&c)[R],
                                                 float (&w)[R]) {
  float rs = 0.0f;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    c[a] = idx[base + a * stride];
    const bool ok = c[a] >= 0 && c[a] < s;
    w[a] = ok ? vals[base + a * stride] * cscale[c[a]] : 0.0f;
    if (w[a] == 0.0f) c[a] = -1;
    rs += w[a];
  }
  const float rinv = 1.0f / (rs + eps);
#pragma unroll
  for (int a = 0; a < R; ++a) w[a] *= rinv;
}
