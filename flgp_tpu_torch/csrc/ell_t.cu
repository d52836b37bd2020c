// K3, K4 and K6-K8: the spectral-stage graph tail.  K6-K8 run on the
// chunked feature-major (nch, r, c) ELL layout of the huge-n path
// (ops/colmajor.py), K3 and K4 on the point-major (n, r) layout of the main
// path through the same bodies: (n, r) is the chunked layout with nch = n,
// c = 1.
//
// Replaces the TPU kernels in flgp_tpu/ops/pallas_kernels.py:
//   K3 ell_colsum         (_ell_colsum_kernel)        C = colsum(Z)
//   K4 ell_norm_gram      (_ell_norm_gram_kernel)     G = Zn^T Zn, D = colsum(Zn)
//   K6 ell_colsum_t       (_ell_colsum_t_kernel)      C = colsum(Z)
//   K7 ell_norm_gram_t    (_ell_norm_gram_t_kernel)   G = Zn^T Zn, D = colsum(Zn)
//   K8 ell_norm_matmat_t  (_ell_norm_matmat_t_kernel) Zn @ W, point-major (nch*c, K)
// with Zn = rownorm(Z diag(cscale)): w1 = w * cscale[idx],
// wn = w1 / (sum w1 + eps) (normalized_point, common.cuh; K5, the
// point-major Zn @ W, is in ell.cu).  Entry (i, k, j) of the chunked layout
// is the k-th neighbour of point i*c + j; pad points (past the real n, in the
// last chunk) carry zero weights and add nothing.
//
// What bounds them on the H100: each reads the compact graph once (8 bytes
// per nonzero: 24 MB at n = 1e6, r = 3; 240 MB at n = 1e7 with
// nch = 153, c = 65536) and then scatters: n*r additions into (s,) for the
// column sums, n*r(r+1)/2 into (s, s) for the Gram (9e7 at n = 1e7).
// Straight into device memory that is the L2's atomic rate under
// contention: K3 as one float atomicAdd a nonzero took 0.33 ms at n = 1e6,
// as long as index_add_, all of it queueing on 1,024 addresses.  So the
// sums are kept in shared memory, whose atomics each SM serves on its own,
// as 32-bit fixed point, 2^-24 a unit (fixed_add, common.cuh): a float
// atomicAdd in shared memory is a loop of read, add and compare-and-swap
// (ATOMS.CAST.SPIN in the SASS), an integer one a single ATOMS.ADD, and
// the sum is exact.  A block flushes its bins once into float64 global
// cells; every term that goes to a global cell directly adds fixed_value,
// the amount a bin would have taken, so every sum is exact and C, G and D
// are the same bits from run to run, whatever the grid, the table's size or
// s (see common.cuh for the bound).  The wrappers round the float64 buffers
// to float32 once.  K8 is bound by its 5.13 GB of output writes at n = 1e7
// and the gathered W rows (s * K floats, L2-resident).
//
// Design: a thread walks entries (column sums) or points (the Gram), so a
// warp's loads are contiguous in both layouts: the chunked layout keeps the
// point axis minor and a thread reads vals[i, k, j] at stride c for each k.
// The TPU kernels carried their sums in VMEM across a grid that runs in
// order; here blocks run in no order, so:
//   K3/K6: one 1024-thread block an SM in a grid-stride loop over the nnz
//       entries (four loads in flight a thread) into a block-private (s,)
//       histogram of fixed-point bins (s <= 12288: 48 KB), flushed with one
//       float64 atomicAdd per nonzero bin; larger s adds straight into the
//       global (s,) buffer.  One block an SM and not more: at n = 1e6 that
//       is 22 entries a thread, and every further block is another s
//       global atomics at the flush on the same s addresses.
//   K4/K7: one 1024-thread block an SM walks the points, a thread a point:
//       gather cscale, row-normalize in registers.  The (s, s) target does
//       not fit in shared memory, but a point touches only pairs among its
//       own r anchors, so the cells a block meets do (about 5e3 of
//       1,048,576 on the torus at s = 1024): they go into a block-private
//       hashed table in shared memory (smem_table_slot, common.cuh; 2^14
//       slots, 128 KB) and D into an (s,) histogram beside it, as K6 does.
//       G is symmetric, so a point adds its r(r+1)/2 pairs (a <= b) under
//       the key lo*s + hi of the sorted anchor pair, not r^2; two slots of a
//       row that name one anchor add their product to the diagonal twice.
//       At the end the block adds each non-empty slot to the global float64
//       cell and to its mirror: 132 * 1e4 global atomics instead of 1.2e8
//       at n = 1e7.  A pair that finds no slot within the probe limit (or
//       whose product is 128 or more in magnitude) adds to the global cells
//       itself, so the result is right for any graph, s and table size; the
//       kernel counts both kinds for the caller.  The float64 buffer is
//       8 s^2 bytes: 8 MB at s = 1024, 1.2 GB at s = 12288.
//   K8: one warp per point, lanes over K, as K5 does; every output offset
//       is size_t (nch * c * K = 1.28e9 at n = 1e7, within 1.7x of 2^31).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBins = 12288;  // 48 KB of fixed-point bins
constexpr int kColsumThreads = 1024; // K3/K6: one block an SM
constexpr int kColsumLoads = 4;      // entries a thread loads before it adds them
constexpr int kGramThreads = 1024;   // K4/K7: one block an SM
constexpr unsigned kGramSlots = 1u << 14;  // K7's table: 128 KB of (key, sum) slots, the most
constexpr int kGramMaxKeyS = 46340;  // lo*s + hi must fit an int
// K7's pair loops and the table's probe loop are unrolled (col[] and w[] in
// registers, the probes of a point's pairs overlapping: with the probe loop
// rolled the kernel took 2.4 times as long at r = 3 on an H100) up to this
// fan-in; above it the r(r+1)/2 inlined inserts take ptxas seconds an
// instance (35 s for r = 1..16 together), so every loop stays rolled there
// and the two arrays go to local memory
constexpr int kGramUnrollR = 6;

// adds v to column c: into the block's fixed-point bin (hist != nullptr),
// else, or at |v| >= kFixedMax, fixed_value(v) into the float64 cell
__device__ __forceinline__ void colsum_add(unsigned* hist, double* __restrict__ out, int s, int c,
                                           float v) {
  if (v == 0.0f || c < 0 || c >= s) return;
  if (hist && fabsf(v) < kFixedMax) {
    const int carry = fixed_add(hist + c, v);
    if (carry) atomicAdd(out + c, carry * kFixedWrap);
  } else {
    atomicAdd(out + c, fixed_value(v));
  }
}

__global__ void __launch_bounds__(kColsumThreads)
ell_colsum_t_kernel(const float* __restrict__ vals, const int* __restrict__ idx, long long nnz,
                    int s, double* __restrict__ out) {
  extern __shared__ unsigned hist[];
  unsigned* bins = s <= kMaxSmemBins ? hist : nullptr;
  if (bins) {
    for (int b = threadIdx.x; b < s; b += blockDim.x) bins[b] = 0u;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; e + (kColsumLoads - 1) * stride < nnz; e += kColsumLoads * stride) {
    int c[kColsumLoads];
    float v[kColsumLoads];
#pragma unroll
    for (int u = 0; u < kColsumLoads; ++u) {
      c[u] = idx[e + u * stride];
      v[u] = vals[e + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kColsumLoads; ++u) colsum_add(bins, out, s, c[u], v[u]);
  }
  for (; e < nnz; e += stride) colsum_add(bins, out, s, idx[e], vals[e]);
  if (bins) {
    __syncthreads();
    for (int b = threadIdx.x; b < s; b += blockDim.x) {
      if (bins[b]) atomicAdd(out + b, bins[b] * kFixedUnit);
    }
  }
}

// adds v to G[lo, hi] and, off the diagonal, to its mirror
__device__ __forceinline__ void gram_add(double* __restrict__ G, int s, int lo, int hi, double v) {
  atomicAdd(G + static_cast<size_t>(lo) * s + hi, v);
  if (lo != hi) atomicAdd(G + static_cast<size_t>(hi) * s + lo, v);
}

// Dynamic shared memory: keys[slots] | sums[slots] | dhist[s] (the last only
// when s <= kMaxSmemBins), the sums and the histogram in fixed point
// (fixed_add, common.cuh).  slots = 0: no table, every pair goes to G.
// stats[0] += pair additions kept in shared memory, stats[1] += those that
// went to the global cells.
template <int R>
__global__ void __launch_bounds__(kGramThreads)
ell_norm_gram_t_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                       const float* __restrict__ cscale, long long npts, int c, int s, float eps,
                       unsigned slots, double* __restrict__ G, double* __restrict__ D,
                       unsigned long long* __restrict__ stats) {
  extern __shared__ int gram_smem[];
  int* keys = gram_smem;
  unsigned* sums = reinterpret_cast<unsigned*>(gram_smem + slots);
  unsigned* dhist = sums + slots;
  const bool dlocal = s <= kMaxSmemBins;
  constexpr bool unrolled = R <= kGramUnrollR;
  for (unsigned h = threadIdx.x; h < slots; h += blockDim.x) {
    keys[h] = kEmptyKey;
    sums[h] = 0u;
  }
  if (dlocal) {
    for (int b = threadIdx.x; b < s; b += blockDim.x) dhist[b] = 0u;
  }
  __syncthreads();

  unsigned kept = 0, spilled = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < npts;
       p += stride) {
    // the point-major layout (c = 1, K4) without a 64-bit division a point
    const size_t base = c == 1 ? static_cast<size_t>(p) * R
                               : static_cast<size_t>(p / c) * R * c + static_cast<size_t>(p % c);
    int col[R];
    float w[R];
    normalized_point<R>(vals, idx, cscale, base, c, s, eps, col, w);
#pragma unroll(unrolled ? R : 1)
    for (int a = 0; a < R; ++a) {
      if (col[a] < 0) continue;
      if (dlocal && fabsf(w[a]) < kFixedMax) {
        const int carry = fixed_add(dhist + col[a], w[a]);
        if (carry) atomicAdd(D + col[a], carry * kFixedWrap);
      } else {
        atomicAdd(D + col[a], fixed_value(w[a]));
      }
#pragma unroll(unrolled ? R : 1)
      for (int b = a; b < R; ++b) {
        if (col[b] < 0) continue;
        const int lo = min(col[a], col[b]), hi = max(col[a], col[b]);
        // slots a < b on one anchor: the (a, b) and (b, a) products both
        // belong on the diagonal
        const float twice = (b > a && lo == hi) ? 2.0f : 1.0f;
        const float v = twice * w[a] * w[b];
        const int h = (slots && fabsf(v) < kFixedMax)
                          ? smem_table_slot<unrolled>(keys, slots, lo * s + hi)
                          : -1;
        if (h >= 0) {
          ++kept;
          const int carry = fixed_add(sums + h, v);
          if (carry) gram_add(G, s, lo, hi, carry * kFixedWrap);
        } else {
          ++spilled;
          gram_add(G, s, lo, hi, fixed_value(v));
        }
      }
    }
  }
  __syncthreads();

  for (unsigned h = threadIdx.x; h < slots; h += blockDim.x) {
    const int key = keys[h];
    if (key != kEmptyKey && sums[h]) gram_add(G, s, key / s, key % s, sums[h] * kFixedUnit);
  }
  if (dlocal) {
    for (int b = threadIdx.x; b < s; b += blockDim.x) {
      if (dhist[b]) atomicAdd(D + b, dhist[b] * kFixedUnit);
    }
  }
  kept = __reduce_add_sync(0xffffffffu, kept);
  spilled = __reduce_add_sync(0xffffffffu, spilled);
  if ((threadIdx.x & 31) == 0) {
    if (kept) atomicAdd(stats, static_cast<unsigned long long>(kept));
    if (spilled) atomicAdd(stats + 1, static_cast<unsigned long long>(spilled));
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

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace

// vals, idx: nnz entries (f32, i32), the (n, r) or (nch, r, c) layout
// flattened; out (s,) float64, zeroed by the caller.
extern "C" int flgp_ell_colsum_t(const void* vals, const void* idx, long long nnz, int s,
                                 void* out, void* stream) {
  if (nnz <= 0) return static_cast<int>(cudaSuccess);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (nnz + kColsumThreads - 1) / kColsumThreads;
  if (blocks > sms) blocks = sms;
  const size_t smem = s <= kMaxSmemBins ? static_cast<size_t>(s) * sizeof(unsigned) : 0;
  ell_colsum_t_kernel<<<static_cast<unsigned>(blocks), kColsumThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx), nnz, s,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// vals, idx (nch, r, c), or (n, r) with nch = n, c = 1; cscale (s,) -> G (s, s),
// D (s,), both float64, and stats (2,) uint64 (pair additions kept in shared memory, sent to global
// cells), all zeroed by the caller.  table_slots: the shared-memory table's
// size, a power of two in [2, 2^14], 0 for the default; s above 46340 runs
// without the table.
extern "C" int flgp_ell_norm_gram_t(const void* vals, const void* idx, const void* cscale,
                                    int nch, int r, int c, int s, float eps, int table_slots,
                                    void* G, void* D, void* stats, void* stream) {
  const long long npts = static_cast<long long>(nch) * c;
  if (npts <= 0) return static_cast<int>(cudaSuccess);
  unsigned slots = table_slots ? static_cast<unsigned>(table_slots) : kGramSlots;
  if (table_slots < 0 || slots < 2 || slots > kGramSlots || (slots & (slots - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s > kGramMaxKeyS) slots = 0;
  const size_t smem = static_cast<size_t>(slots) * (sizeof(int) + sizeof(unsigned)) +
                      (s <= kMaxSmemBins ? static_cast<size_t>(s) * sizeof(unsigned) : 0);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (npts + kGramThreads - 1) / kGramThreads;
  if (blocks > sms) blocks = sms;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* ii = static_cast<const int*>(idx);
  const float* cs = static_cast<const float*>(cscale);
  double* g = static_cast<double*>(G);
  double* dd = static_cast<double*>(D);
  unsigned long long* stt = static_cast<unsigned long long*>(stats);
  switch (r) {
#define FLGP_GRAM_T_CASE(R)                                                                    \
  case R:                                                                                      \
    err = cudaFuncSetAttribute(ell_norm_gram_t_kernel<R>,                                      \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,                    \
                               static_cast<int>(smem));                                        \
    if (err != cudaSuccess) return static_cast<int>(err);                                      \
    ell_norm_gram_t_kernel<R><<<grid, kGramThreads, smem, st>>>(v, ii, cs, npts, c, s, eps,    \
                                                                slots, g, dd, stt);            \
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
