// Weighted k-means++ over the C candidates of k-means|| (Bahmani et al.
// 2012): s - 1 Gumbel-max draws, each of the candidate with the largest
// log(max(w * mindc, 1e-30)) + noise[k], each followed by
// mindc = min(mindc, dcc[j]), all in one launch of one block.
//
// It replaces no Pallas kernel.  The reference runs this reduction as one
// compiled lax.scan (flgp_tpu/ops/kmeans.py, _kmeanspar_rows); the port's
// plain version, ops/kmeans.py:_weighted_kmeanspp_plain, runs the same loop
// in PyTorch: s - 1 serial steps of a handful of tiny kernels each over
// C ~ 2s floats, paced by the host's launches (1,023 steps at s = 1024).
//
// What bounds it on the H100: latency.  Each step needs the previous step's
// argmax, so the s - 1 steps are a serial chain: read one row of dcc (from
// L2: the (C, C) matrix, 16.8 MB at C = 2049, was just written), a log per
// candidate, a block-wide argmax.  By bytes the work is 2 (s - 1) C floats,
// 0.005 ms at 3.35 TB/s; a step costs a few L2 and barrier latencies.
//
// Design:
//  * One block of 1024 threads loops over the steps.  Thread t owns the
//    candidates c = t, t + 1024, ...: their mindc and w sit in shared memory
//    and only their owner reads or writes them, so only the argmax needs a
//    barrier.  C is bounded by shared memory (kMaxC).
//  * The arithmetic is the plain version's, rounded as PyTorch rounds it on
//    the card: w * mindc, clamp at 1e-30 (NaN kept), logf, + noise, each
//    rounded on its own (__fmul_rn, __fadd_rn: no contraction into an FMA;
//    no fast math), and min with torch.minimum's NaN rule.  So the picks are
//    the plain version's, index for index.
//  * The argmax is torch.argmax's: the largest value, NaN above all, the
//    first index on ties.  A value becomes an unsigned key that orders as
//    the floats do (-0 as +0, every NaN the largest); a warp takes the
//    largest key and the least index holding it with two __reduce_*_sync,
//    its lane 0 writes the pair to shared memory, and after one barrier
//    every warp reduces the 32 pairs the same way.  The pairs alternate
//    between two buffers by step, so one barrier a step is enough.
//  * The first pick is argmax(w), the same reduction over the weights.
//  * Output: the s indices, int64, written by thread 0.  One launch on the
//    caller's stream, no allocation.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// mindc and w of every candidate in dynamic shared memory, 8 bytes each,
// beside the two buffers of per-warp pairs: within kMaxBlockSmem
constexpr int kMaxC = 28672;
static_assert(2 * sizeof(float) * kMaxC + 2 * kWarps * (sizeof(unsigned) + sizeof(int)) <=
                  kMaxBlockSmem,
              "mindc and w of kMaxC candidates must fit one block's shared memory");

// An unsigned key that orders as torch.argmax orders floats: larger value,
// larger key; -0 as +0; every NaN above +inf.  No value maps to 0, so 0 is
// "no candidate".
__device__ __forceinline__ unsigned order_key(float v) {
  if (isnan(v)) return 0xffffffffu;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// torch.minimum and torch.clamp(min=) on the card: a NaN operand wins
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// The block's largest key and the least index holding it, known to every
// thread on return.  (key, idx) is the calling thread's best; pair_key and
// pair_idx are this step's buffer of kWarps pairs.
__device__ __forceinline__ int block_argmax(unsigned key, int idx, unsigned* pair_key,
                                            int* pair_idx) {
  const int lane = threadIdx.x & 31;
  unsigned top = __reduce_max_sync(kFull, key);
  int at = __reduce_min_sync(kFull, key == top ? idx : INT_MAX);
  if (lane == 0) {
    pair_key[threadIdx.x >> 5] = top;
    pair_idx[threadIdx.x >> 5] = at;
  }
  __syncthreads();
  key = pair_key[lane];
  idx = pair_idx[lane];
  top = __reduce_max_sync(kFull, key);
  return __reduce_min_sync(kFull, key == top ? idx : INT_MAX);
}

__global__ void __launch_bounds__(kThreads)
    weighted_kmeanspp_kernel(const float* __restrict__ dcc, const float* __restrict__ w,
                             const float* __restrict__ noise, int C, int steps,
                             long long* __restrict__ out) {
  extern __shared__ float smem[];
  float* mind = smem;        // (C,) min over the chosen of dcc[chosen][c]
  float* wsh = smem + C;     // (C,) the candidates' weights
  __shared__ unsigned pair_key[2][kWarps];
  __shared__ int pair_idx[2][kWarps];

  unsigned best = 0;
  int at = INT_MAX;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float wc = w[c];
    wsh[c] = wc;
    mind[c] = __int_as_float(0x7f800000);   // +inf: the first step's min is dcc[j0]
    const unsigned key = order_key(wc);
    if (key > best) {        // strictly: the thread's first index on ties
      best = key;
      at = c;
    }
  }
  int j = block_argmax(best, at, pair_key[1], pair_idx[1]);
  if (threadIdx.x == 0) out[0] = j;

  for (int k = 0; k < steps; ++k) {
    const float* __restrict__ row = dcc + static_cast<size_t>(j) * C;
    const float* __restrict__ z = noise + static_cast<size_t>(k) * C;
    best = 0;
    at = INT_MAX;
#pragma unroll 4
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float m = nan_min(mind[c], row[c]);
      mind[c] = m;
      const float logit = logf(clamp_min(__fmul_rn(wsh[c], m), 1e-30f));
      const unsigned key = order_key(__fadd_rn(logit, z[c]));
      if (key > best) {
        best = key;
        at = c;
      }
    }
    j = block_argmax(best, at, pair_key[k & 1], pair_idx[k & 1]);
    if (threadIdx.x == 0) out[k + 1] = j;
  }
}

}  // namespace

// dcc (C, C), w (C,), noise (steps, C): float32, contiguous, on the device,
// 1 <= C <= kMaxC (hopper_kernels.KMEANSPP_MAX_C) -> out (steps + 1,) int64:
// argmax(w), then each step's pick.
extern "C" int flgp_weighted_kmeanspp(const void* dcc, const void* w, const void* noise, int C,
                                      int steps, void* out, void* stream) {
  if (C < 1 || C > kMaxC || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(C);
  if (smem > 48 * 1024) {    // above the default, dynamic shared memory has to be asked for
    const cudaError_t err = cudaFuncSetAttribute(
        weighted_kmeanspp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  weighted_kmeanspp_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dcc), static_cast<const float*>(w),
      static_cast<const float*>(noise), C, steps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
