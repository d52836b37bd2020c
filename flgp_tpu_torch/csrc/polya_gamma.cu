// The Polya-Gamma draw J*(1, z) for z >= 0 (PG(1, c) = J*(1, |c|/2) / 4):
// the Devroye alternating-series sampler of Polson, Scott and Windle (2013),
// one thread a lane, every lane finished on the device.
//
// It replaces no Pallas kernel.  The reference draws PG(1, c) in
// flgp_tpu/ops/polya_gamma.py as three masked lax.while_loop's over the
// whole batch; the port's plain version, ops/polya_gamma.py:_sample_jstar,
// runs the same three loops in PyTorch and reads on the host after every
// round whether all lanes are done.  Its caller is the PG-Gibbs chain
// (inference/pg_gibbs.py), one draw of 1,000 to 5,000 lanes a sweep.
//
// What bounds it on the H100: latency.  A lane's work is a few outer rounds
// (P(accept) >= 0.57 a round), each a proposal and a handful of series terms,
// all in registers; a few thousand lanes fill a few dozen blocks.  The loop's
// cost was host round trips and ~30 elementwise launches a round; here a
// draw is one launch with no host read, and its time is the slowest lane's.
//
// Design:
//  * The sampler of ops/polya_gamma.py, with its constants and caps, per lane:
//    the mixture proposal (weights p and q of _mass_texpon), the exponential
//    tail above t = 0.64 and the truncated inverse Gaussian below it (mu > t:
//    the chi^2-style proposal; mu <= t: Michael-Schucany-Haas resampled until
//    <= t), then the alternating-series squeeze with a_n's piecewise terms.
//    At most 64 outer rounds, 32 inner rounds and 128 series terms; an
//    undecided series accepts, an inner loop that never accepts proposes
//    t / 2, a lane never accepted keeps t.  So a NaN lane ends at the caps
//    exactly as the loop's does, and no lane runs unbounded.
//  * Arithmetic in the input's type (float or double), as the loop's.
//  * Random numbers from Philox4x32-10 (curand), subsequence = lane index.
//    Seed and offset are an int64 pair the wrapper draws from the caller's
//    torch.Generator on the device just before the launch; the kernel reads
//    them from device memory, so nothing crosses to the host and one seed
//    gives the same bits on every run.  A lane draws only what its branch
//    needs: the same law as the loop's, another stream.
//  * One launch on the caller's stream, no allocation.

#include <cuda_runtime.h>
#include <curand_kernel.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRounds = 64;      // outer rejection rounds
constexpr int kMaxInner = 32;       // inner rounds of the truncated proposals
constexpr int kMaxTerms = 128;      // alternating-series terms
constexpr double kT = 0.64;         // series and proposal cut point
constexpr double kPi = 3.14159265358979323846;
constexpr double kSqrtHalf = 0.70710678118654752440;

using Philox = curandStatePhilox4_32_10_t;

__device__ __forceinline__ float uniform(Philox* st, float) { return curand_uniform(st); }
__device__ __forceinline__ double uniform(Philox* st, double) { return curand_uniform_double(st); }
__device__ __forceinline__ float normal(Philox* st, float) { return curand_normal(st); }
__device__ __forceinline__ double normal(Philox* st, double) { return curand_normal_double(st); }
__device__ __forceinline__ float mexp(float x) { return expf(x); }
__device__ __forceinline__ double mexp(double x) { return exp(x); }
__device__ __forceinline__ float mlog(float x) { return logf(x); }
__device__ __forceinline__ double mlog(double x) { return log(x); }
__device__ __forceinline__ float msqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double msqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float merfc(float x) { return erfcf(x); }
__device__ __forceinline__ double merfc(double x) { return erfc(x); }

// Exp(1) as -log U, U uniform on (0, 1]
template <typename T>
__device__ __forceinline__ T exponential(Philox* st) {
  return -mlog(uniform(st, T(0)));
}

template <typename T>
__device__ __forceinline__ T norm_cdf(T x) {
  return T(0.5) * merfc(-x * T(kSqrtHalf));
}

// Series coefficient a_n(x) of the J*(1, .) density, piecewise at t
template <typename T>
__device__ __forceinline__ T a_n(int n, T x) {
  const T nh = T(n) + T(0.5);
  if (x <= T(kT)) {
    const T u = T(2.0) / (T(kPi) * x);
    return T(kPi) * nh * u * msqrt(u) * mexp(T(-2.0) * nh * nh / x);
  }
  return T(kPi) * nh * mexp(-nh * nh * T(kPi * kPi) * x / T(2.0));
}

// Inverse Gaussian IG(mu, 1) (Michael-Schucany-Haas)
template <typename T>
__device__ __forceinline__ T sample_ig(Philox* st, T mu) {
  const T g = normal(st, T(0));
  const T y = g * g;
  const T my = mu * y;
  const T x = mu + T(0.5) * mu * my - T(0.5) * mu * msqrt(T(4.0) * my + my * my);
  const T u = uniform(st, T(0));
  return u <= mu / (mu + x) ? x : mu * mu / (x < T(1e-30) ? T(1e-30) : x);
}

// IG(mu = 1/z, 1) truncated to (0, t]; t / 2 where no inner round accepts
template <typename T>
__device__ T sample_rtigauss(Philox* st, T z) {
  const T mu = T(1.0) / (z < T(1e-10) ? T(1e-10) : z);   // a NaN z stays NaN, as torch.clamp's
  if (mu > T(kT)) {
    for (int i = 0; i < kMaxInner; ++i) {
      const T e1 = exponential<T>(st);
      const T e2 = exponential<T>(st);
      if (e1 * e1 <= T(2.0) * e2 / T(kT)) {
        const T d = T(1.0) + T(kT) * e1;
        const T x = T(kT) / (d * d);
        if (uniform(st, T(0)) <= mexp(T(-0.5) * z * z * x)) return x;
      }
    }
  } else {
    for (int i = 0; i < kMaxInner; ++i) {
      const T x = sample_ig(st, mu);
      if (x <= T(kT)) return x;
    }
  }
  return T(0.5 * kT);
}

// The alternating-series accept/reject of a proposal x; undecided after
// kMaxTerms terms it accepts (the partial sums have converged)
template <typename T>
__device__ bool series_accept(Philox* st, T x) {
  T s = a_n(0, x);
  const T y = uniform(st, T(0)) * s;
  for (int n = 1; n <= kMaxTerms; ++n) {
    const T a = a_n(n, x);
    if (n & 1) {
      s -= a;
      if (y <= s) return true;
    } else {
      s += a;
      if (y > s) return false;
    }
  }
  return true;
}

template <typename T>
__device__ T sample_jstar(Philox* st, T z) {
  // mixture weights: p the exponential tail's mass above t, q the truncated
  // IG's below it (its CDF at t, written in z, finite at z = 0; the second
  // term, which is exp(z) * Phi(b) and vanishes as z grows, is added only
  // where Phi(b) has not underflowed, so exp(z) never meets a zero)
  const T K = T(kPi * kPi / 8.0) + z * z / T(2.0);
  const T p = (T(kPi) / (T(2.0) * K)) * mexp(-K * T(kT));
  const T sqrt_t = msqrt(T(kT));
  const T tail = norm_cdf(-(T(kT) * z + T(1.0)) / sqrt_t);
  const T q = T(2.0) * (mexp(-z) * norm_cdf((T(kT) * z - T(1.0)) / sqrt_t)
                        + (tail > T(0) ? mexp(z) * tail : T(0)));
  const T ratio = p / (p + q);
  for (int round = 0; round < kMaxRounds; ++round) {
    const T x = uniform(st, T(0)) < ratio ? T(kT) + exponential<T>(st) / K
                                          : sample_rtigauss(st, z);
    if (series_accept(st, x)) return x;
  }
  return T(kT);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    polya_gamma_kernel(const T* __restrict__ z, const long long* __restrict__ key, long long n,
                       T* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  Philox st;
  curand_init(static_cast<unsigned long long>(key[0]), static_cast<unsigned long long>(i),
              static_cast<unsigned long long>(key[1]), &st);
  out[i] = sample_jstar(&st, z[i]);
}

}  // namespace

// z (n,) f32 or f64 (dbl), key (2,) int64 on the device: Philox seed and
// offset -> out (n,) J*(1, z) in z's type.
extern "C" int flgp_polya_gamma(const void* z, const void* key, long long n, int dbl, void* out,
                                void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const long long*>(key);
  if (dbl) {
    polya_gamma_kernel<double><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const double*>(z), k, n, static_cast<double*>(out));
  } else {
    polya_gamma_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(z), k, n, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
