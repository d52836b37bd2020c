// K3, K4, K6 and K7: the spectral-stage graph tail before the eigenvector
// extension.  K6 and K7 run on the chunked feature-major (nch, r, c) ELL
// layout of the huge-n path (ops/colmajor.py), K3 and K4 on the point-major
// (n, r) layout of the main path through the same bodies: (n, r) is the
// chunked layout with nch = n, c = 1.
//
// Replaces the TPU kernels in flgp_tpu/ops/pallas_kernels.py:
//   K3 ell_colsum         (_ell_colsum_kernel)        C = colsum(Z)
//   K4 ell_norm_gram      (_ell_norm_gram_kernel)     G = Zn^T Zn, D = colsum(Zn)
//   K6 ell_colsum_t       (_ell_colsum_t_kernel)      C = colsum(Z)
//   K7 ell_norm_gram_t    (_ell_norm_gram_t_kernel)   G = Zn^T Zn, D = colsum(Zn)
// with Zn = rownorm(Z diag(cscale)): w1 = w * cscale[idx],
// wn = w1 / (sum w1 + eps) (normalized_point, common.cuh).  K8, Zn @ W on
// the chunked layout, shares one body with K5 in ell.cu: its output writes
// (5.13 GB at n = 1e7) bound it, and that body keeps them streaming from
// every SM, 16 bytes a store.  Entry (i, k, j) of the chunked layout
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
// to float32 once.
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
//
// Fan-in.  K3/K6 walk the flat entries and take any r as they are.  K4/K7's
// body keeps a point's r weights and anchors in registers, so r is a
// template parameter, 1 <= r <= 16; every larger r takes the run-time-r
// body below, which the TPU kernels' any-r matches: a warp a point, its
// (weight, anchor) pairs in the warp's slice of shared memory beside the
// table (the slice holds `cap` of them, r at every r whose 32 warps' pairs
// fit the 227 KB beside table and histogram: r <= 380 at s = 1024; an entry
// past it is formed again from the graph where it is needed), the
// r(r+1)/2 pairs a <= b dealt to the lanes 32 apart, row by row.  Every
// lane forms the point's row sum itself, the entries in order from its
// broadcast loads, with normalized_point's expressions (scaled_entry,
// common.cuh): the same weights, so the same terms into the same exact
// sums, and Ĝ and D are the templated body's bits at every r both take.
// What bounds it is as above: the graph's bytes, and the pair additions,
// r(r+1)/2 a point, into the table.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

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

// The run-time-r body's steps, each what the templated body above does
// inline.  The templated body keeps them inline: through these helpers, with
// normalized_point forming its entries through scaled_entry, it ran 4%
// slower at r = 3 on an H100.
// adds a point's normalized weight w of anchor col to D: into the block's
// fixed-point bin (dlocal), else, or at |w| >= kFixedMax, into the float64 cell
__device__ __forceinline__ void d_add(unsigned* dhist, bool dlocal, double* __restrict__ D,
                                      int col, float w) {
  if (dlocal && fabsf(w) < kFixedMax) {
    const int carry = fixed_add(dhist + col, w);
    if (carry) atomicAdd(D + col, carry * kFixedWrap);
  } else {
    atomicAdd(D + col, fixed_value(w));
  }
}

// adds the product of slots a <= b of one point, weights wa, wb on anchors
// ca, cb (both >= 0), to G: into the table's slot for the sorted anchor pair
// when it finds one (kept), else into the global cells (spilled)
template <bool UNROLL>
__device__ __forceinline__ void pair_add(int* keys, unsigned* sums, unsigned slots,
                                         double* __restrict__ G, int s, int a, int b, int ca,
                                         int cb, float wa, float wb, unsigned& kept,
                                         unsigned& spilled) {
  const int lo = min(ca, cb), hi = max(ca, cb);
  // slots a < b on one anchor: the (a, b) and (b, a) products both
  // belong on the diagonal
  const float twice = (b > a && lo == hi) ? 2.0f : 1.0f;
  const float v = twice * wa * wb;
  const int h = (slots && fabsf(v) < kFixedMax)
                    ? smem_table_slot<UNROLL>(keys, slots, lo * s + hi)
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

// the table and the histogram emptied, before the block's first addition
__device__ __forceinline__ void gram_smem_init(int* keys, unsigned* sums, unsigned slots,
                                               unsigned* dhist, bool dlocal, int s) {
  for (unsigned h = threadIdx.x; h < slots; h += blockDim.x) {
    keys[h] = kEmptyKey;
    sums[h] = 0u;
  }
  if (dlocal) {
    for (int b = threadIdx.x; b < s; b += blockDim.x) dhist[b] = 0u;
  }
  __syncthreads();
}

// after the block's last addition: every non-empty slot and bin added once to
// the global cells, the counts to stats
__device__ __forceinline__ void gram_flush(const int* keys, const unsigned* sums, unsigned slots,
                                           const unsigned* dhist, bool dlocal, int s,
                                           double* __restrict__ G, double* __restrict__ D,
                                           unsigned kept, unsigned spilled,
                                           unsigned long long* __restrict__ stats) {
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

// A point's (normalized weight, anchor) pair in the run-time-r body
struct Pair {
  float w;
  int c;
};

// entry a of the point at base (entries `stride` apart): from the warp's
// slice while a < cap, else formed again from the graph, the same floats
__device__ __forceinline__ Pair wide_entry(const Pair* pairs, int cap, int a,
                                           const float* __restrict__ vals,
                                           const int* __restrict__ idx,
                                           const float* __restrict__ cscale, size_t base,
                                           size_t stride, int s, float rinv) {
  if (a < cap) return pairs[a];
  int col;
  const float w1 = scaled_entry(vals, idx, cscale, base + a * stride, s, col);
  return Pair{w1 * rinv, col};
}

// K4/K7 at run-time r: a warp a point, walking the points 32 warps a block
// apart.  Dynamic shared memory as the templated body's, then, 8-byte
// aligned, each warp's `cap` pairs.
__global__ void __launch_bounds__(kGramThreads)
ell_norm_gram_wide_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                          const float* __restrict__ cscale, long long npts, int r, int c, int s,
                          float eps, unsigned slots, int cap, double* __restrict__ G,
                          double* __restrict__ D, unsigned long long* __restrict__ stats) {
  extern __shared__ int gram_smem[];
  int* keys = gram_smem;
  unsigned* sums = reinterpret_cast<unsigned*>(gram_smem + slots);
  unsigned* dhist = sums + slots;
  const bool dlocal = s <= kMaxSmemBins;
  const size_t head = 2 * static_cast<size_t>(slots) + (dlocal ? s : 0);   // words
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  Pair* pairs = reinterpret_cast<Pair*>(gram_smem + ((head + 1) & ~static_cast<size_t>(1))) +
                static_cast<size_t>(warp) * cap;
  gram_smem_init(keys, sums, slots, dhist, dlocal, s);

  unsigned kept = 0, spilled = 0;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  for (long long p = static_cast<long long>(blockIdx.x) * warps + warp; p < npts; p += stride) {
    const size_t base = c == 1 ? static_cast<size_t>(p) * r
                               : static_cast<size_t>(p / c) * r * c + static_cast<size_t>(p % c);
    // the row sum in normalized_point's order, every lane alike; lane
    // a % 32 keeps entry a
    float rs = 0.0f;
    for (int a = 0; a < r; ++a) {
      int col;
      const float w1 = scaled_entry(vals, idx, cscale, base + static_cast<size_t>(a) * c, s, col);
      rs += w1;
      if (a < cap && (a & 31) == lane) pairs[a] = Pair{w1, col};
    }
    const float rinv = 1.0f / (rs + eps);
    for (int a = lane; a < r && a < cap; a += 32) pairs[a].w *= rinv;
    __syncwarp();
    for (int a = lane; a < r; a += 32) {
      const Pair e = wide_entry(pairs, cap, a, vals, idx, cscale, base, c, s, rinv);
      if (e.c >= 0) d_add(dhist, dlocal, D, e.c, e.w);
    }
    // the pairs a <= b of the upper triangle row by row, lane l taking the
    // l-th and every 32nd after it
    int a = 0, b = lane;
    while (a < r && b >= r) b += ++a - r;
    while (a < r) {
      const Pair ea = wide_entry(pairs, cap, a, vals, idx, cscale, base, c, s, rinv);
      const Pair eb = wide_entry(pairs, cap, b, vals, idx, cscale, base, c, s, rinv);
      if (ea.c >= 0 && eb.c >= 0)
        pair_add<false>(keys, sums, slots, G, s, a, b, ea.c, eb.c, ea.w, eb.w, kept, spilled);
      b += 32;
      while (a < r && b >= r) b += ++a - r;
    }
    __syncwarp();   // the pairs read before the next point's overwrite them
  }
  gram_flush(keys, sums, slots, dhist, dlocal, s, G, D, kept, spilled, stats);
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

namespace {

// flgp_ell_norm_gram_t and its run-time-r twin; wide: the run-time-r body at
// any r, pair_cap > 0 holding at most that many pairs a warp in shared memory
int norm_gram(const void* vals, const void* idx, const void* cscale, int nch, int r, int c, int s,
              float eps, int table_slots, void* G, void* D, void* stats, void* stream, bool wide,
              int pair_cap) {
  const long long npts = static_cast<long long>(nch) * c;
  if (npts <= 0) return static_cast<int>(cudaSuccess);
  unsigned slots = table_slots ? static_cast<unsigned>(table_slots) : kGramSlots;
  if (r < 1 || table_slots < 0 || slots < 2 || slots > kGramSlots || (slots & (slots - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s > kGramMaxKeyS) slots = 0;
  size_t smem = static_cast<size_t>(slots) * (sizeof(int) + sizeof(unsigned)) +
                (s <= kMaxSmemBins ? static_cast<size_t>(s) * sizeof(unsigned) : 0);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* ii = static_cast<const int*>(idx);
  const float* cs = static_cast<const float*>(cscale);
  double* g = static_cast<double*>(G);
  double* dd = static_cast<double*>(D);
  unsigned long long* stt = static_cast<unsigned long long*>(stats);
  if (wide || r > kTemplatedMaxR) {
    constexpr int warps = kGramThreads / 32;
    const size_t head = (smem + sizeof(Pair) - 1) / sizeof(Pair) * sizeof(Pair);
    long long cap = head < kMaxBlockSmem ? (kMaxBlockSmem - head) / (warps * sizeof(Pair)) : 0;
    if (cap > r) cap = r;
    if (pair_cap > 0 && cap > pair_cap) cap = pair_cap;
    smem = head + static_cast<size_t>(cap) * warps * sizeof(Pair);
    long long blocks = (npts + warps - 1) / warps;
    if (blocks > sms) blocks = sms;
    err = cudaFuncSetAttribute(ell_norm_gram_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ell_norm_gram_wide_kernel<<<static_cast<unsigned>(blocks), kGramThreads, smem, st>>>(
        v, ii, cs, npts, r, c, s, eps, slots, static_cast<int>(cap), g, dd, stt);
    return static_cast<int>(cudaGetLastError());
  }
  long long blocks = (npts + kGramThreads - 1) / kGramThreads;
  if (blocks > sms) blocks = sms;
  const dim3 grid(static_cast<unsigned>(blocks));
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
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals, idx (nch, r, c), or (n, r) with nch = n, c = 1; cscale (s,) -> G (s, s),
// D (s,), both float64, and stats (2,) uint64 (pair additions kept in shared memory, sent to global
// cells), all zeroed by the caller.  table_slots: the shared-memory table's
// size, a power of two in [2, 2^14], 0 for the default; s above 46340 runs
// without the table.  r <= 16 takes the templated body, a larger r the
// run-time-r body.
extern "C" int flgp_ell_norm_gram_t(const void* vals, const void* idx, const void* cscale,
                                    int nch, int r, int c, int s, float eps, int table_slots,
                                    void* G, void* D, void* stats, void* stream) {
  return norm_gram(vals, idx, cscale, nch, r, c, s, eps, table_slots, G, D, stats, stream, false,
                   0);
}

// The same through the run-time-r body at any r >= 1, holding at most
// pair_cap (> 0; 0: as many as fit) pairs a warp in shared memory: the
// templated body's bit oracle at r <= 16, for the tests and the smoke test.
extern "C" int flgp_ell_norm_gram_t_wide(const void* vals, const void* idx, const void* cscale,
                                         int nch, int r, int c, int s, float eps,
                                         int table_slots, int pair_cap, void* G, void* D,
                                         void* stats, void* stream) {
  return norm_gram(vals, idx, cscale, nch, r, c, s, eps, table_slots, G, D, stats, stream, true,
                   pair_cap);
}
