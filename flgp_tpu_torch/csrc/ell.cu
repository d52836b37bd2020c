// K5 and K8: the eigenvector extension Zn @ W, one body for both layouts.
//
// Replaces the TPU kernels in flgp_tpu/ops/pallas_kernels.py:
//   K5 ell_norm_matmat    (_ell_norm_matmat_kernel)   Zn @ W, (n, r) layout
//   K8 ell_norm_matmat_t  (_ell_norm_matmat_t_kernel) Zn @ W, chunked (nch, r, c)
//                                                     layout, point-major (nch*c, K)
// with Zn = rownorm(Z diag(cscale)): w1 = w * cscale[idx], wn = w1 / (sum w1 + eps)
// (normalized_point, common.cuh, shared with K4 and K7 in ell_t.cu).  K5 is
// the chunked layout with nch = n, c = 1, as K3 and K4 run K6's and K7's
// bodies.  Entry (i, k, j) of the chunked layout is the k-th neighbour of
// point i*c + j; pad points (past the real n, in the last chunk) carry zero
// weights and get rows of exact zeros.
//
// What bounds it on the H100: the (n, K) float32 output, written once
// (5.12 GB at n = 1e7, K = 128; 512 MB at n = 1e6): 1.53 ms and 0.153 ms at
// 3.35 TB/s.  The compact graph is 8 bytes a nonzero (240 MB and 24 MB at
// r = 3).  W (s * K floats, 0.5 MB at s = 1024) is gathered r times an
// output row, from L1 and L2, never from device memory more than once.
//
// Design.  The TPU kernel recast the gather as a one-hot matmul because
// Mosaic has none; Hopper gathers natively.  A first body ran one warp a
// row with every lane redoing the row's normalization and 4-byte accesses;
// it wrote 5.13 GB at about 1.7 TB/s.  What held it back, and what this
// body does about it:
//   1. One warp a row, one row a warp: each warp's life was one dependent
//      chain (graph loads, cscale gathers, divide, W gathers, store) for
//      400-512 bytes of output.  Here a warp takes a tile of 32 points and
//      walks their 32 output rows (12.8-16 KB), kU items a lane in flight at
//      once, and the grid is persistent (the SM count times the resident
//      blocks, four an SM up to r = 8) and walks the tiles.  Where the tiles
//      are too few to give every resident warp two (n = 4800, 7e4), `split`
//      warps share a tile's output, each normalizing its 32 points itself.
//   2. All 32 lanes redid normalized_point: here a lane normalizes its own
//      point (normalized_point<R>, so the weights are the floats K4 and K7
//      form) and writes the (weight, anchor) pairs to shared memory; the
//      row walk reads them back, a broadcast where lanes share a row.
//   3. 4-byte accesses, 78% of the lanes busy in the last pass at K = 100:
//      here a lane takes 16-byte pieces (float4 gathers of W rows, float4
//      stores) of the tile's flattened (row, piece) range, so every lane
//      works at any K (K = 100: 25 pieces a row, 800 a tile).  When
//      K % 4 != 0 or W or out is not 16-byte aligned, the same body runs
//      with 4-byte pieces.
//   4. The chunked layout's points are consecutive addresses: here a lane
//      loads its own point's R (value, index) pairs, so a warp's loads are
//      coalesced along c (and contiguous in the (n, r) layout).
//   5. The output streamed through L2 with the default policy, competing
//      with the W rows every row gathers: here every store is evict-first
//      (st.global.cs, __stcs); plain stores were slower.
// Four blocks an SM of 256 threads beat two with twice the items in flight
// a lane, and more gathers in flight did not help: the W rows hit in L1 and
// L2 whatever their order.  What is left between the body and its bound at
// n = 1e7 is the graph's reads interleaved with the output's writes;
// staging the next tile's graph early (cp.async, an L2 prefetch) did not
// shorten it, nor did one block sweeping a contiguous range.
// The sum for each output element is acc = 0, then acc = fmaf(w[a],
// W[c[a]][k], acc) for a = 0..R-1, skipping an entry with c[a] < 0: one
// order, whatever the layout, the split or the piece width, so both layouts
// give the same bits.  No atomics: deterministic.  Indices outside [0, s) contribute nothing
// (knn never produces them; the guard keeps a bad input from reading out of
// bounds), nor do zero weights.
//
// Fan-in.  The tiled body keeps a lane's R pairs and R x kU gathers in
// registers, so R is a template parameter, 1 <= R <= 16.  Every larger r
// takes the run-time-r variant of the same body (the TPU kernels take any
// r): the tile's pairs in dynamic shared memory, `cap` of a point's r in the
// warp's slice (r itself while the block's eight slices fit 227 KB: r <= 113;
// an entry past the slice is formed again from the graph with the point's
// rinv, kept beside the pairs), the weights formed as normalized_point forms
// them (scaled_entry, common.cuh) and summed into rinv in its order, and
// the same fmaf chain a = 0 .. r-1 from +0 with the same skipped entries,
// its gathers issued eight at a time ahead of their multiply-adds (one at
// a time, the body ran 40% slower than the templated one at r = 16 on an
// H100).  So at r <= 16 it gives the templated body's bits, and at every r
// the output is the plain version's product to rounding.  The r gathers of
// an output piece hit W's rows in L1 and L2; the bound is the output's
// writes as above, plus the graph's 8r bytes a point.

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 32;            // points a tile: one lane each
constexpr int kWarps = 8;            // a block of 256 threads
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 16;        // warps that may share one tile's output
constexpr int kJobsPerWarp = 2;      // split until the jobs are this many times the warps

struct Weighted {
  float w;
  int c;
};

__device__ __forceinline__ float4 fma_piece(float w, float4 g, float4 acc) {
  return make_float4(fmaf(w, g.x, acc.x), fmaf(w, g.y, acc.y), fmaf(w, g.z, acc.z),
                     fmaf(w, g.w, acc.w));
}
__device__ __forceinline__ float fma_piece(float w, float g, float acc) { return fmaf(w, g, acc); }

template <class V>
__device__ __forceinline__ V zero_piece() {
  if constexpr (std::is_same<V, float4>::value) {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    return 0.0f;
  }
}

// One warp a job: job = tile * split + part.  The warp normalizes the
// tile's 32 points (a lane each) into shared memory, then its lanes take
// items part*32 + lane, + 32*split, ... of the tile's rows * pieces items in
// row-major order, kU at a time: item t is piece t % pieces of row
// t / pieces, and its output is the t-th piece of the tile's contiguous
// output block.  V = float4 (16-byte pieces, K % 4 == 0 and W, out aligned)
// or float.
template <int R, class V>
__global__ void __launch_bounds__(kThreads, R <= 8 ? 4 : 2)
ell_norm_matmat_tiles_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                             const float* __restrict__ cscale, const float* __restrict__ W,
                             long long npts, int c, int s, int K, float eps, int split,
                             float* __restrict__ out) {
  // items a lane has in flight: R * kU gathers, at most 8 within the 64
  // registers of four blocks an SM (r <= 8; two blocks above)
  constexpr int kU = R <= 4 ? 2 : 1;
  __shared__ Weighted pairs[kWarps][R][kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Weighted(&mine)[R][kTile] = pairs[warp];
  const int pieces = K / static_cast<int>(sizeof(V) / sizeof(float));
  const V* __restrict__ Wv = reinterpret_cast<const V*>(W);
  V* __restrict__ outv = reinterpret_cast<V*>(out);
  const long long jobs = (npts + kTile - 1) / kTile * split;
  // a lane's next item is step items on: drow rows and dpiece pieces
  const int step = kTile * split;
  const int drow = step / pieces, dpiece = step % pieces;
  for (long long job = static_cast<long long>(blockIdx.x) * kWarps + warp; job < jobs;
       job += static_cast<long long>(gridDim.x) * kWarps) {
    const long long tile = job / split;
    const int part = static_cast<int>(job - tile * split);
    const long long p0 = tile * kTile;
    const long long p = p0 + lane;
    int col[R];
    float w[R];
    if (p < npts) {
      const size_t base = c == 1 ? static_cast<size_t>(p) * R
                                 : static_cast<size_t>(p / c) * R * c + static_cast<size_t>(p % c);
      normalized_point<R>(vals, idx, cscale, base, c, s, eps, col, w);
    } else {
#pragma unroll
      for (int a = 0; a < R; ++a) {
        col[a] = -1;
        w[a] = 0.0f;
      }
    }
    __syncwarp();   // the last job's reads of the pairs are done
#pragma unroll
    for (int a = 0; a < R; ++a) mine[a][lane] = Weighted{w[a], col[a]};
    __syncwarp();

    const int rows = static_cast<int>(min(static_cast<long long>(kTile), npts - p0));
    V* __restrict__ otile = outv + static_cast<size_t>(p0) * pieces;
    const int t0 = part * kTile + lane;
    int row = t0 / pieces, piece = t0 - row * pieces;
    while (row < rows) {
      int rr[kU], pc[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        rr[u] = row;
        pc[u] = piece;
        row += drow;
        piece += dpiece;
        if (piece >= pieces) {
          piece -= pieces;
          ++row;
        }
      }
      Weighted e[kU][R];
      V g[kU][R];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int a = 0; a < R; ++a) {
          e[u][a] = rr[u] < rows ? mine[a][rr[u]] : Weighted{0.0f, -1};
          g[u][a] = e[u][a].c >= 0
                        ? __ldg(Wv + static_cast<size_t>(e[u][a].c) * pieces + pc[u])
                        : zero_piece<V>();
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (rr[u] >= rows) continue;
        V acc = zero_piece<V>();
#pragma unroll
        for (int a = 0; a < R; ++a) {
          if (e[u][a].c >= 0) acc = fma_piece(e[u][a].w, g[u][a], acc);
        }
        __stcs(otile + rr[u] * pieces + pc[u], acc);
      }
    }
  }
}

template <int R, class V>
cudaError_t launch_tiles(const float* v, const int* ii, const float* cs, const float* w,
                         long long npts, int c, int s, int K, float eps, float* o,
                         cudaStream_t st) {
  const auto kernel = ell_norm_matmat_tiles_kernel<R, V>;
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(sms) * per_sm;   // blocks at once
  const long long tiles = (npts + kTile - 1) / kTile;
  const int pieces = K / static_cast<int>(sizeof(V) / sizeof(float));
  // share a tile among warps only while the tiles cannot give every
  // resident warp kJobsPerWarp jobs, and never below a piece a lane
  int split = 1;
  while (split < kMaxSplit && split < pieces &&
         tiles * split < kJobsPerWarp * resident * kWarps)
    ++split;
  const long long jobs = tiles * split;
  long long blocks = (jobs + kWarps - 1) / kWarps;
  if (blocks > resident) blocks = resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(v, ii, cs, w, npts, c, s, K, eps,
                                                             split, o);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_tiles_r(const float* v, const int* ii, const float* cs, const float* w,
                           long long npts, int c, int s, int K, float eps, float* o,
                           cudaStream_t st) {
  const bool vec = K % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0 &&
                   reinterpret_cast<size_t>(o) % 16 == 0;
  return vec ? launch_tiles<R, float4>(v, ii, cs, w, npts, c, s, K, eps, o, st)
             : launch_tiles<R, float>(v, ii, cs, w, npts, c, s, K, eps, o, st);
}

// The run-time-r tiled body: the tile's pairs, [warp][a][lane] for a < cap,
// and each lane's rinv after them in dynamic shared memory; one item (a
// piece of a row) at a time, its r gathers issued kBatch at a time.
constexpr int kBatch = 8;

template <class V>
__global__ void __launch_bounds__(kThreads)
ell_norm_matmat_wide_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                            const float* __restrict__ cscale, const float* __restrict__ W,
                            long long npts, int r, int c, int s, int K, float eps, int split,
                            int cap, float* __restrict__ out) {
  extern __shared__ Weighted wide_pairs[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Weighted* mine = wide_pairs + static_cast<size_t>(warp) * cap * kTile;
  float* rinvs = reinterpret_cast<float*>(wide_pairs + static_cast<size_t>(kWarps) * cap * kTile) +
                 warp * kTile;
  const int pieces = K / static_cast<int>(sizeof(V) / sizeof(float));
  const V* __restrict__ Wv = reinterpret_cast<const V*>(W);
  V* __restrict__ outv = reinterpret_cast<V*>(out);
  const long long jobs = (npts + kTile - 1) / kTile * split;
  const int step = kTile * split;
  const int drow = step / pieces, dpiece = step % pieces;
  const int held = min(r, cap);
  for (long long job = static_cast<long long>(blockIdx.x) * kWarps + warp; job < jobs;
       job += static_cast<long long>(gridDim.x) * kWarps) {
    const long long tile = job / split;
    const int part = static_cast<int>(job - tile * split);
    const long long p0 = tile * kTile;
    const long long p = p0 + lane;
    __syncwarp();   // the last job's reads of the pairs are done
    float rinv = 0.0f;
    if (p < npts) {
      const size_t base = c == 1 ? static_cast<size_t>(p) * r
                                 : static_cast<size_t>(p / c) * r * c + static_cast<size_t>(p % c);
      float rs = 0.0f;
      for (int a = 0; a < r; ++a) {
        int col;
        const float w1 = scaled_entry(vals, idx, cscale, base + static_cast<size_t>(a) * c, s,
                                      col);
        rs += w1;
        if (a < held) mine[a * kTile + lane] = Weighted{w1, col};
      }
      rinv = 1.0f / (rs + eps);
      for (int a = 0; a < held; ++a) mine[a * kTile + lane].w *= rinv;
    } else {
      for (int a = 0; a < held; ++a) mine[a * kTile + lane] = Weighted{0.0f, -1};
    }
    rinvs[lane] = rinv;
    __syncwarp();

    const int rows = static_cast<int>(min(static_cast<long long>(kTile), npts - p0));
    V* __restrict__ otile = outv + static_cast<size_t>(p0) * pieces;
    const int t0 = part * kTile + lane;
    int row = t0 / pieces, piece = t0 - row * pieces;
    while (row < rows) {
      size_t pbase = 0;   // the row's point's entries, where some are not held
      if (held < r) {
        const long long pp = p0 + row;
        pbase = c == 1 ? static_cast<size_t>(pp) * r
                       : static_cast<size_t>(pp / c) * r * c + static_cast<size_t>(pp % c);
      }
      V acc = zero_piece<V>();
      int a = 0;
      // kBatch gathers in flight before their multiply-adds, in order
      for (; a + kBatch <= held; a += kBatch) {
        Weighted e[kBatch];
        V g[kBatch];
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          e[t] = mine[(a + t) * kTile + row];
          g[t] = e[t].c >= 0 ? __ldg(Wv + static_cast<size_t>(e[t].c) * pieces + piece)
                             : zero_piece<V>();
        }
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          if (e[t].c >= 0) acc = fma_piece(e[t].w, g[t], acc);
        }
      }
      for (; a < r; ++a) {
        Weighted e;
        if (a < held) {
          e = mine[a * kTile + row];
        } else {
          e.w = scaled_entry(vals, idx, cscale, pbase + static_cast<size_t>(a) * c, s, e.c) *
                rinvs[row];
        }
        const V g = e.c >= 0 ? __ldg(Wv + static_cast<size_t>(e.c) * pieces + piece)
                             : zero_piece<V>();
        if (e.c >= 0) acc = fma_piece(e.w, g, acc);
      }
      __stcs(otile + row * pieces + piece, acc);
      row += drow;
      piece += dpiece;
      if (piece >= pieces) {
        piece -= pieces;
        ++row;
      }
    }
  }
}

template <class V>
cudaError_t launch_wide(const float* v, const int* ii, const float* cs, const float* w,
                        long long npts, int r, int c, int s, int K, float eps, int pair_cap,
                        float* o, cudaStream_t st) {
  const auto kernel = ell_norm_matmat_wide_kernel<V>;
  constexpr size_t per_pair = static_cast<size_t>(kWarps) * kTile * sizeof(Weighted);
  constexpr size_t rinvs = static_cast<size_t>(kWarps) * kTile * sizeof(float);
  long long cap = (kMaxBlockSmem - rinvs) / per_pair;
  if (cap > r) cap = r;
  if (pair_cap > 0 && cap > pair_cap) cap = pair_cap;
  const size_t smem = static_cast<size_t>(cap) * per_pair + rinvs;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long tiles = (npts + kTile - 1) / kTile;
  const int pieces = K / static_cast<int>(sizeof(V) / sizeof(float));
  int split = 1;
  while (split < kMaxSplit && split < pieces &&
         tiles * split < kJobsPerWarp * resident * kWarps)
    ++split;
  const long long jobs = tiles * split;
  long long blocks = (jobs + kWarps - 1) / kWarps;
  if (blocks > resident) blocks = resident;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(v, ii, cs, w, npts, r, c, s, K,
                                                                eps, split,
                                                                static_cast<int>(cap), o);
  return cudaGetLastError();
}

// The tiled body by r (templated up to r = 16, run-time r above), or with
// runtime_r the run-time-r tiled body at any r >= 1 with at most pair_cap
// (> 0; 0: as many as fit) pairs a point in shared memory
int matmat(const void* vals, const void* idx, const void* cscale, const void* W, long long npts,
           int r, int c, int s, int K, float eps, void* out, void* stream, bool runtime_r,
           int pair_cap = 0) {
  if (npts <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  if (r < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* ii = static_cast<const int*>(idx);
  const float* cs = static_cast<const float*>(cscale);
  const float* w = static_cast<const float*>(W);
  float* o = static_cast<float*>(out);
  if (runtime_r || r > kTemplatedMaxR) {
    const bool vec = K % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0 &&
                     reinterpret_cast<size_t>(o) % 16 == 0;
    return static_cast<int>(
        vec ? launch_wide<float4>(v, ii, cs, w, npts, r, c, s, K, eps, pair_cap, o, st)
            : launch_wide<float>(v, ii, cs, w, npts, r, c, s, K, eps, pair_cap, o, st));
  }
  switch (r) {
#define FLGP_MATMAT_CASE(R) \
  case R:                   \
    return static_cast<int>(launch_tiles_r<R>(v, ii, cs, w, npts, c, s, K, eps, o, st));
    FLGP_R_CASES(FLGP_MATMAT_CASE)
#undef FLGP_MATMAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K5: vals, idx (n, r); cscale (s,); W (s, K) -> out (n, K).
extern "C" int flgp_ell_norm_matmat(const void* vals, const void* idx, const void* cscale,
                                    const void* W, int n, int r, int s, int K, float eps,
                                    void* out, void* stream) {
  return matmat(vals, idx, cscale, W, n, r, 1, s, K, eps, out, stream, false);
}

// K8: vals, idx (nch, r, c); cscale (s,); W (s, K) -> out (nch * c, K).
extern "C" int flgp_ell_norm_matmat_t(const void* vals, const void* idx, const void* cscale,
                                      const void* W, int nch, int r, int c, int s, int K,
                                      float eps, void* out, void* stream) {
  return matmat(vals, idx, cscale, W, static_cast<long long>(nch) * c, r, c, s, K, eps, out,
                stream, false);
}

// K5 (nch = n, c = 1) and K8 through the run-time-r body at any r >= 1, at
// most pair_cap (> 0; 0: as many as fit) pairs a point in shared memory: the
// templated body's bit oracle at r <= 16, for the tests and the smoke test.
extern "C" int flgp_ell_norm_matmat_wide(const void* vals, const void* idx, const void* cscale,
                                         const void* W, int nch, int r, int c, int s, int K,
                                         float eps, int pair_cap, void* out, void* stream) {
  return matmat(vals, idx, cscale, W, static_cast<long long>(nch) * c, r, c, s, K, eps, out,
                stream, true, pair_cap);
}
