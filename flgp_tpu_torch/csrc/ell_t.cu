// K6-K8: the spectral-stage graph tail on the chunked feature-major
// (nch, r, c) ELL layout of the huge-n path (ops/colmajor.py).
//
// Replaces the TPU kernels in flgp_tpu/ops/pallas_kernels.py:
//   K6 ell_colsum_t       (_ell_colsum_t_kernel)      C = colsum(Z)
//   K7 ell_norm_gram_t    (_ell_norm_gram_t_kernel)   G = Zn^T Zn, D = colsum(Zn)
//   K8 ell_norm_matmat_t  (_ell_norm_matmat_t_kernel) Zn @ W, point-major (nch*c, K)
// with Zn = rownorm(Z diag(cscale)) as in K3-K5 (ell.cu).  Entry (i, k, j)
// of the layout is the k-th neighbour of point i*c + j; pad points (past the
// real n, in the last chunk) carry zero weights and add nothing.
//
// What bounds them on the H100, at n = 1e7 (nch = 153, r = 3, c = 65536,
// s = 1024, K = 128): K6 and K7 read the compact graph once (8 bytes per
// nonzero, 240 MB) and are bound by atomic throughput into an (s,) or
// (s, s) target that stays in the 50 MB L2; K8 by its 5.13 GB of output
// writes and the gathered W rows (s * K floats, L2-resident).
//
// Design: the layout keeps the point axis minor, so a thread per point
// reads vals[i, k, j] and idx[i, k, j] at stride c for each k and a warp's
// loads are contiguous.  The TPU kernels carried their sums in VMEM across
// a grid that runs in order; here blocks run in no order, so:
//   K6: a grid-stride loop over the nnz entries into a block-private (s,)
//       histogram in shared memory (s <= 12288 fits the default 48 KB),
//       flushed with one global atomicAdd per nonzero bin; larger s adds
//       straight into the global (s,) buffer.
//   K7: one thread per point; gather cscale, row-normalize in registers
//       (normalized_point, shared with K4), then atomicAdd D and all r^2
//       pairs of G, as K4 does, but into float64 buffers that the wrapper
//       rounds to float32: at n = 1e7 a cell of G sums ~3e4 terms, and
//       float32 atomics of that length missed the 1e-5 * max|G| gate
//       against a float64 sum on the H100 (max abs err 0.39; the TPU kernel
//       adds 512-point block sums from the MXU, a shorter chain).  Double
//       atomics are native on sm_90 and the 8 MB buffer stays in L2.
//   K8: one warp per point, lanes over K, as K5 does; every output offset
//       is size_t (nch * c * K = 1.28e9 at n = 1e7, within 1.7x of 2^31).
// Atomic sums reorder additions from run to run; compare with tolerances.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBins = 12288;  // 48 KB of float bins

__global__ void ell_colsum_t_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                                    long long nnz, int s, float* __restrict__ out) {
  extern __shared__ float hist[];
  const bool local = s <= kMaxSmemBins;
  if (local) {
    for (int b = threadIdx.x; b < s; b += blockDim.x) hist[b] = 0.0f;
    __syncthreads();
  }
  float* target = local ? hist : out;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < nnz;
       e += stride) {
    const int c = idx[e];
    const float v = vals[e];
    if (v != 0.0f && c >= 0 && c < s) atomicAdd(target + c, v);
  }
  if (local) {
    __syncthreads();
    for (int b = threadIdx.x; b < s; b += blockDim.x) {
      if (hist[b] != 0.0f) atomicAdd(out + b, hist[b]);
    }
  }
}

template <int R>
__global__ void ell_norm_gram_t_kernel(const float* __restrict__ vals,
                                       const int* __restrict__ idx,
                                       const float* __restrict__ cscale, long long npts, int c,
                                       int s, float eps, double* __restrict__ G,
                                       double* __restrict__ D) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= npts) return;
  const size_t base = static_cast<size_t>(p / c) * R * c + static_cast<size_t>(p % c);
  int col[R];
  float w[R];
  normalized_point<R>(vals, idx, cscale, base, c, s, eps, col, w);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    if (col[a] < 0) continue;
    atomicAdd(D + col[a], static_cast<double>(w[a]));
    double* grow = G + static_cast<size_t>(col[a]) * s;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      if (col[b] >= 0) atomicAdd(grow + col[b], static_cast<double>(w[a]) * w[b]);
    }
  }
}

template <int R>
__global__ void ell_norm_matmat_t_kernel(const float* __restrict__ vals,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ cscale,
                                         const float* __restrict__ W, long long npts, int c,
                                         int s, int K, float eps, float* __restrict__ out) {
  const long long p = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= npts) return;
  const size_t base = static_cast<size_t>(p / c) * R * c + static_cast<size_t>(p % c);
  int col[R];
  float w[R];
  normalized_point<R>(vals, idx, cscale, base, c, s, eps, col, w);
  float* orow = out + static_cast<size_t>(p) * K;
  for (int k = lane; k < K; k += 32) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < R; ++a) {
      if (col[a] >= 0) acc = fmaf(w[a], W[static_cast<size_t>(col[a]) * K + k], acc);
    }
    orow[k] = acc;
  }
}

}  // namespace

// vals, idx: (nch, r, c) flattened to nnz entries (f32, i32); out (s,) f32,
// zeroed by the caller.
extern "C" int flgp_ell_colsum_t(const void* vals, const void* idx, long long nnz, int s,
                                 void* out, void* stream) {
  if (nnz <= 0) return static_cast<int>(cudaSuccess);
  long long blocks = (nnz + kThreads - 1) / kThreads;
  if (blocks > 132 * 4) blocks = 132 * 4;
  const size_t smem = s <= kMaxSmemBins ? static_cast<size_t>(s) * sizeof(float) : 0;
  ell_colsum_t_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx), nnz, s,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// vals, idx (nch, r, c); cscale (s,) -> G (s, s), D (s,), both float64 and
// zeroed by the caller.
extern "C" int flgp_ell_norm_gram_t(const void* vals, const void* idx, const void* cscale,
                                    int nch, int r, int c, int s, float eps, void* G, void* D,
                                    void* stream) {
  const long long npts = static_cast<long long>(nch) * c;
  if (npts <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((npts + kThreads - 1) / kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* ii = static_cast<const int*>(idx);
  const float* cs = static_cast<const float*>(cscale);
  double* g = static_cast<double*>(G);
  double* dd = static_cast<double*>(D);
  switch (r) {
#define FLGP_GRAM_T_CASE(R)                                                                    \
  case R:                                                                                      \
    ell_norm_gram_t_kernel<R><<<grid, kThreads, 0, st>>>(v, ii, cs, npts, c, s, eps, g, dd);   \
    break;
    FLGP_R_CASES(FLGP_GRAM_T_CASE)
#undef FLGP_GRAM_T_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals, idx (nch, r, c); cscale (s,); W (s, K) -> out (nch * c, K).
extern "C" int flgp_ell_norm_matmat_t(const void* vals, const void* idx, const void* cscale,
                                      const void* W, int nch, int r, int c, int s, int K,
                                      float eps, void* out, void* stream) {
  const long long npts = static_cast<long long>(nch) * c;
  if (npts <= 0) return static_cast<int>(cudaSuccess);
  const long long pts_per_block = kThreads / 32;
  const dim3 grid(static_cast<unsigned>((npts + pts_per_block - 1) / pts_per_block));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* ii = static_cast<const int*>(idx);
  const float* cs = static_cast<const float*>(cscale);
  const float* w = static_cast<const float*>(W);
  float* o = static_cast<float*>(out);
  switch (r) {
#define FLGP_MATMAT_T_CASE(R)                                                                  \
  case R:                                                                                      \
    ell_norm_matmat_t_kernel<R><<<grid, kThreads, 0, st>>>(v, ii, cs, w, npts, c, s, K, eps,  \
                                                           o);                                 \
    break;
    FLGP_R_CASES(FLGP_MATMAT_T_CASE)
#undef FLGP_MATMAT_T_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
