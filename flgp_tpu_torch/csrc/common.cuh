// Shared by the kernel sources: the fan-in values the kernels are
// instantiated for.  A kernel keeps r values per row in registers, so r is a
// template parameter; the C entry points switch on it with this list, and
// send every other r to the kernel family's one run-time-r body.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#define FLGP_R_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)
constexpr int kTemplatedMaxR = 16;   // the last of FLGP_R_CASES

// Shared memory a block may take on the H100 (and the H200): 227 KB.  The
// run-time-r bodies size their per-point arrays against it.
constexpr size_t kMaxBlockSmem = 232448;

// The current device's SM count, for the grids of one block an SM and the
// persistent grids.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

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

// normalized_point's first loop, one entry at a time: the run-time-r bodies
// form each w1 with it, sum them in normalized_point's order and scale by
// the same rinv, so they get the same floats.
__device__ __forceinline__ float scaled_entry(const float* __restrict__ vals,
                                              const int* __restrict__ idx,
                                              const float* __restrict__ cscale, size_t at, int s,
                                              int& c) {
  c = idx[at];
  const bool ok = c >= 0 && c < s;
  const float w = ok ? vals[at] * cscale[c] : 0.0f;
  if (w == 0.0f) c = -1;
  return w;
}

// A block-private table in shared memory for scattered sums whose targets
// are far too many for a dense shared array but of which one block meets
// only a few thousand: open addressing over `slots` keys (a power of two
// >= 2, filled with kEmptyKey by the block beforehand), the sums in an
// array of the caller's beside it.  smem_table_slot returns the slot of
// `key` (>= 0), claiming an empty one with atomicCAS on first sight, after
// at most kTableProbes neighbouring slots; -1 when none of them is free or
// the key's own, and the caller then adds to the global target itself.  So
// the sums are right whatever the table's size: it decides only how many
// additions stay on the SM.  After a __syncthreads() the block walks the
// slots and adds each non-empty (key, sum) to the global target once.
// UNROLL: the probe loop unrolled, so that the compiler can overlap the
// probes of a thread's independent adds (at a few adds a thread that is
// most of the speed); rolled, an instance with many inlined adds builds in a
// fraction of the time.
constexpr int kEmptyKey = -1;
constexpr int kTableProbes = 8;

template <bool UNROLL>
__device__ __forceinline__ int smem_table_slot(int* keys, unsigned slots, int key) {
  // Fibonacci hashing: the top log2(slots) bits of key * 2^32/phi
  unsigned h = (static_cast<unsigned>(key) * 2654435769u) >> __clz(slots - 1);
#pragma unroll(UNROLL ? kTableProbes : 1)
  for (int t = 0; t < kTableProbes; ++t) {
    h &= slots - 1;
    int seen = *static_cast<volatile int*>(keys + h);
    if (seen == kEmptyKey) seen = atomicCAS(keys + h, kEmptyKey, key);
    if (seen == key || seen == kEmptyKey) return static_cast<int>(h);
    ++h;
  }
  return -1;
}

// Sums in shared memory as 32-bit fixed point, 2^-24 a unit: an addition is
// one native integer atomic (a float atomicAdd in shared memory is a loop of
// read, add and compare-and-swap), exact, and so the same in any order.  A
// bin holds the sum modulo 2^32 units (256.0); fixed_add returns the carry
// out of it, -1, 0 or +1, which the caller adds to the global target as
// carry * kFixedWrap right away.  The block's sum is then the carries plus
// the bin read as unsigned, times kFixedUnit.  For |v| < kFixedMax only.
// A term that goes to a float64 global cell instead (no bin, no table slot,
// or |v| >= kFixedMax) adds fixed_value(v): the same amount a bin would
// have taken.  So every term of a sum is a multiple of 2^-24, every partial
// sum in float64 is exact while the cell's sum of |terms| stays below 2^29,
// and the result is the same bits whatever the order, the grid or the path
// each term took.
constexpr float kFixedMax = 128.0f;
constexpr double kFixedUnit = 1.0 / 16777216.0;  // 2^-24
constexpr double kFixedWrap = 256.0;             // 2^32 units

__device__ __forceinline__ int fixed_add(unsigned* bin, float v) {
  const int inc = __float2int_rn(v * 16777216.0f);
  const unsigned old = atomicAdd(bin, static_cast<unsigned>(inc));
  const unsigned now = old + static_cast<unsigned>(inc);
  return (inc > 0 && now < old) ? 1 : (inc < 0 && now > old) ? -1 : 0;
}

// v rounded to a whole number of 2^-24 units, ties to even, as fixed_add
// rounds it; v itself from kFixedMax on (a float32 of that size is a
// multiple of 2^-16)
__device__ __forceinline__ double fixed_value(float v) {
  return fabsf(v) < kFixedMax ? __float2int_rn(v * 16777216.0f) * kFixedUnit
                              : static_cast<double>(v);
}
