// K2: local anchor embedding weights by fixed-iteration FISTA.
//
// Replaces the TPU kernel flgp_tpu/ops/pallas_kernels.py:fused_lae_tiles
// (_lae_fista_kernel), together with the XLA Gram assembly that feeds it
// (assemble_lae_gram_t).  Per point i, with U_i its r nearest anchors:
// G = U_i U_i^T, b = U_i x, then `iters` FISTA steps from z = 1/r with step
// 1/L, L = max row-abs-sum of G + 1e-12, momentum d' = (1 + sqrt(1+4d^2))/2,
// each step projected onto the probability simplex.
//
// What bounds it on the H100: per point ~iters * (3r^2 + 11r + 9) float
// operations on data that fits in registers, against r*d + d + r floats
// read and r written once.  With 16 or more warps resident per scheduler
// the chains of one point hide behind those of the others, so the time is
// the number of instructions a step issues over the SM's issue rate (one
// warp instruction per scheduler and cycle).  The design therefore removes
// every instruction from the loop that is not the algorithm's:
//   * the momentum alpha_it = (d_{it-1} - 1)/d_it does not depend on the
//     data.  The wrapper computes the sequence once on the host in float32
//     (ops/lae.py:fista_momentum, the plain version's own recurrence) and
//     the block copies it to shared memory: one broadcast shared-memory read
//     a step instead of an IEEE division, a square root and their chain in
//     every thread.
//   * the simplex projection divides only where a division is needed.
//     theta = (css_rho - 1)/rho is one of the quotients q_k = (css_k - 1)/
//     (k + 1) that the rho test already formed from the same operands, so
//     it is selected, not recomputed.  Division by a power of two is a
//     multiplication; by any other constant k + 1 it is the multiplication
//     by the rounded reciprocal and one exact-residual correction
//     (div_const, three instructions, correctly rounded over the range the
//     loop can reach: flgp_lae_div_check sweeps every float to show it).
//     The k = 0 test, u_0 - (u_0 - 1) > 0, holds for every |u_0| < 2^24 and
//     is dropped.
//   * the loop is unrolled by two so that z and z_prev swap by renaming.
// One thread per point: the thread gathers its r anchor rows itself, forms
// G and b in registers (no (n, r, r) array is written), runs every step in
// registers and writes its r weights once.
//
// Layouts.  One body serves both callers: the graph arrays are read as the
// chunked feature-major (nch, r, c) layout of ops/colmajor.py, entry
// (i, k, j) the k-th neighbour of point i*c + j, of which the point-major
// (n, r) layout is the case c = 1; the cloud is read through two strides
// ((n, d) row-major or (d, n) feature-major, where a warp's loads of one
// coordinate are contiguous).  Points past the real n (pads of the last
// chunk) get weight exactly 0.  So the huge-n path is one launch over the
// whole cloud instead of a copy, a launch and a transpose per chunk.
//
// Arithmetic: every product and sum rounded on its own, in the order of the
// plain version (ops/lae.py:lae_weights_plain): __fmul_rn/__fadd_rn keep
// nvcc from contracting a*b+c, so the weights are the plain version's bit
// for bit.  With nearly collinear anchors the problem is ill-conditioned,
// 150 steps do not converge and the iterate keeps the imprint of rounding:
// fused multiply-adds, or the rho test without its quotient, would take
// fewer instructions but move the weights by up to some 3e-4, beyond the
// 2e-4 that the plain version is held to.  The body and the launcher are in
// lae.cuh; this file instantiates the 16 fan-ins.
//
// Fan-in.  These bodies take 1 <= r <= 16 (G's triangle in registers).  Every
// larger r goes to the run-time-r body in lae_wide.cu: a warp a point, G in
// shared memory, the same roundings in the same order, so the plain
// version's bits at every r up to the one limit left, r^2 floats of G beside
// the momentum table in one block's 227 KB (r = 240 at 150 steps).

#include "lae.cuh"

namespace flgp_k2 {
namespace {

// counts the floats x, over every bit pattern with x = 0 or
// 2^-60 <= |x| <= 2^60, for which div_const<M>(x) differs in value from x / M
template <int M>
__global__ void div_check_kernel(unsigned long long* __restrict__ bad) {
  unsigned long long mine = 0;
  const unsigned long long stride = static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long bits = static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
                                 threadIdx.x;
       bits < (1ull << 32); bits += stride) {
    const float x = __uint_as_float(static_cast<unsigned>(bits));
    const float ax = fabsf(x);
    if (!(ax == 0.0f || (ax >= 0x1p-60f && ax <= 0x1p60f))) continue;
    const float want = __fdiv_rn(x, static_cast<float>(M));
    mine += (div_const<M>(x) != want) ? 1 : 0;  // by value: the zeros' signs may differ
  }
  if (mine) atomicAdd(bad, mine);
}

}  // namespace
}  // namespace flgp_k2

// X: point p's coordinate k at X[p*xs_p + k*xs_k] (f32); U (s, d) f32;
// idx (nch, r, c) i32 with nch*c = npts >= n, the (n, r) layout being c = 1;
// alpha (iters,) f32, the momentum sequence -> out as idx, f32, zero on the
// npts - n pad points.  r <= 16 takes the templated body, a larger r the
// run-time-r body (r^2 + iters floats within 227 KB).
extern "C" int flgp_lae(const void* X, long long xs_p, long long xs_k, const void* U,
                        const void* idx, long long n, long long npts, int c, int s, int d, int r,
                        int iters, const void* alpha, void* out, void* stream) {
  if (npts <= 0) return static_cast<int>(cudaSuccess);
  if (c <= 0 || iters < 0 || n > npts) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(iters) * sizeof(float) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const flgp_k2::Args a{static_cast<const float*>(X), xs_p, xs_k, static_cast<const float*>(U),
                        static_cast<const int*>(idx), n, npts, c, s, d, r, iters,
                        static_cast<const float*>(alpha), static_cast<float*>(out),
                        static_cast<cudaStream_t>(stream)};
  return flgp_k2::launch(a);
}

// flgp_lae through the run-time-r body at any r it takes
// (1 <= r, r^2 + iters floats within 227 KB): the templated bodies' bit
// oracle at r <= 16, for the tests and the smoke test.
extern "C" int flgp_lae_wide(const void* X, long long xs_p, long long xs_k, const void* U,
                             const void* idx, long long n, long long npts, int c, int s, int d,
                             int r, int iters, const void* alpha, void* out, void* stream) {
  if (npts <= 0) return static_cast<int>(cudaSuccess);
  if (c <= 0 || iters < 0 || n > npts) return static_cast<int>(cudaErrorInvalidValue);
  const flgp_k2::Args a{static_cast<const float*>(X), xs_p, xs_k, static_cast<const float*>(U),
                        static_cast<const int*>(idx), n, npts, c, s, d, r, iters,
                        static_cast<const float*>(alpha), static_cast<float*>(out),
                        static_cast<cudaStream_t>(stream)};
  return flgp_k2::launch_wide(a);
}

// *bad (zeroed by the caller) += the number of floats on which the
// projection's constant division by m (1 <= m <= 16) is not the IEEE quotient.
extern "C" int flgp_lae_div_check(int m, void* bad, void* stream) {
  unsigned long long* out = static_cast<unsigned long long*>(bad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
#define FLGP_DIV_CASE(M)                                        \
  case M:                                                       \
    flgp_k2::div_check_kernel<M><<<132 * 8, 256, 0, st>>>(out); \
    break;
    FLGP_R_CASES(FLGP_DIV_CASE)
#undef FLGP_DIV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
