// K1's tiled body: the r nearest anchors for every width d other than 2 and 3.
//
// Replaces, with knn.cu (the entry point flgp_knn, the anchor pre-pass and
// the rounding rule, all shared), the TPU kernel
// flgp_tpu/ops/pallas_kernels.py:fused_knn (_knn_kernel :50, pallas_call
// :99) at the widths of real data: the multiclass data's d = 16, MNIST's 784.
//
// What bounds it on the H100: chip_smoke.py:work counts n*s*(2d + 2)
// float32 operations against 4(n + s)d + 8nr bytes, so at every width the
// paths use it is bound by the CUDA cores' 67 TFLOP/s, one FMA a lane a
// cycle.  Exact float32 has no tensor-core form: TF32, or a 3xTF32 split,
// would round x.u otherwise.
//
// Design: a GEMM's register tiling, with the top-r selection after each
// anchor tile.
//  * A block of 256 threads owns 64 rows of X and walks the anchors in tiles
//    of 128.  A thread holds a 4 x 8 tile of partial dot products in
//    registers (rows ty + 16q, anchors tx + 16c): 32 independent FMA chains,
//    where the run-time-d body of knn.cu ran one.
//  * The features go through in slabs of 16, three slabs in flight: the
//    slab of X (64 x 16) and of the packed anchor records (128 x 16) sit in
//    shared memory row-major, filled by 16-byte cp.async (the records are
//    padded to a multiple of 4 floats, tiled_rec; X's rows when d is a
//    multiple of 4, else 4 bytes at a time).  Per 4 features a thread reads
//    each of its rows and anchors once, 16 bytes, one wavefront a warp.
//  * Each chain stays in one register across the slabs and runs over the
//    features in order, bounded at k < d (no padded feature takes part), so
//    d^2 is the run-time-d body's bits: a chain starts at -0, and
//    fmaf(x0, a0, -0) is __fmul_rn(x0, a0) exactly, the sign of a zero
//    product included; |x|^2 is one thread's sum of rounded squares a row;
//    d^2 = (|x|^2 + m) + |u|^2, |u|^2 brought with the tile's first slab.
//  * After a tile's last slab the block writes its 64 x 128 d^2 to shared
//    memory, and 4 neighbouring lanes a row scan it, each 32 anchors in
//    increasing order into a sorted list in registers (LEX false: ties keep
//    the lower index).  A candidate is offered only if it is below the
//    lane's last entry and not above the smallest last entry of the row's 4
//    lists, shared after each tile: no candidate above that can be among
//    the row's r nearest, so the lists stay exact where it counts and most
//    of a row's candidates cost one compare.  merge_and_store's shuffle
//    butterfly merges the 4 lists in (d^2, index) order.
//  * Where the row blocks are few (n = 3000 makes 47 blocks of 64 rows on
//    132 SMs), `split` blocks divide a row block's anchor tiles, each a
//    contiguous run of them (blockIdx.y).  Each writes its rows' lists into
//    scratch that the wrapper allocates, and knn_merge_kernel merges the
//    split lists of a row in (d^2, index) order: the same list, whatever
//    the split.  For this body `split` counts blocks;
//    ops/hopper_kernels.py:knn_anchor_split chooses it.  The forced old body
//    (flgp_knn's `legacy`, for the tests and chip_smoke.py only) keeps
//    knn.cu's meaning, lanes that share a row.
//
// Times (chip_smoke.py phase 11 on an H100 80GB HBM3 at 700 W; PERF.md
// section 6 has every shape): at n = 7e4, s = 600, r = 3 it takes 0.128 ms
// at d = 16 (bound 0.021; the run-time-d body 2.47, the plain version 1.47),
// 0.300 at d = 64 (0.082), 0.976 at d = 256 (0.322) and 2.770 at d = 784
// (0.984).  What keeps it from the bound: the product loop runs at some 24
// TFLOP/s, half of what cuBLAS's float32 GEMM of the same shape reaches in
// the same run, and at d = 16 the selection of the first tiles, where a
// warp runs the insertion for a candidate whenever any of its 32 lanes
// takes it.

#include <cstdint>

#include "knn.cuh"

namespace flgp_k1 {
namespace {

constexpr int kTiledThreads = 256;
constexpr int kTM = 4;                       // rows of a thread's tile of dot products
constexpr int kTN = 8;                       // anchors of it
constexpr int kBM = 16 * kTM;                // rows a block: 16 row groups
constexpr int kBN = 16 * kTN;                // anchors a tile: 16 anchor groups
constexpr int kBK = 16;                      // features a slab
constexpr int kStages = 3;                   // slabs in shared memory: one used, two loading
constexpr int kLDS = kBK + 4;                // a slab row: 80 bytes, see fma_slab
constexpr int kLDD = kBN + 8;                // a d^2 row: see the epilogue and the selection
constexpr int kLanesARow = kTiledThreads / kBM;      // selection threads that share a row
constexpr int kMergeThreads = 256;
// shared memory a block: the slabs of X and of the anchors, the tiles'
// |u|^2, a tile's d^2, the rows' |x|^2
constexpr size_t kSmemBytes =
    sizeof(float) * (kStages * ((kBM + kBN) * kLDS + kBN) + kBM * kLDD + kBM);
static_assert(kBM * kBK / 4 == kTiledThreads, "one 16-byte copy of X a thread a slab");
static_assert(kBN * kBK / 4 == 2 * kTiledThreads, "two of the anchors");
static_assert(kBN == kLanesARow * 32, "a selection lane takes 32 anchors a tile");

// Copies from global to shared memory, asynchronous: 16 bytes of which the
// first `bytes` are read and the rest written 0 (16-byte aligned ends), or
// 4 bytes, none read and 0 written unless ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sdst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sdst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// topr_insert<R, false> with every entry's move decided at once: in a list
// sorted by d^2, "the candidate goes before entry k" holds from some k on,
// so entry k takes entry k - 1, the candidate or itself by two compares of
// the old list.  The same list as the bubble pass, in a few dependent steps
// where that pass takes R.
template <int R>
__device__ __forceinline__ void topr_insert_flat(float (&bd)[R], int (&bi)[R], float cd, int ci) {
  bool before[R];
#pragma unroll
  for (int k = 0; k < R; ++k) before[k] = cd < bd[k];
#pragma unroll
  for (int k = R - 1; k > 0; --k) {
    bd[k] = before[k - 1] ? bd[k - 1] : before[k] ? cd : bd[k];
    bi[k] = before[k - 1] ? bi[k - 1] : before[k] ? ci : bi[k];
  }
  bd[0] = before[0] ? cd : bd[0];
  bi[0] = before[0] ? ci : bi[0];
}

// `kn` features of a slab (row-major, kLDS floats a row) into the thread's
// chains: rows ty + 16q, anchors tx + 16c.  Per 4 features a 16-byte read
// of each row and each anchor, then the 4 features in order.  In a warp the
// rows are 4 neighbours and the anchors 8, 80 bytes apart: distinct
// 16-byte bank groups, so every read is one wavefront.
template <bool FULL>
__device__ __forceinline__ void fma_slab(const float* xrows, const float* arows, int kn,
                                         float (&acc)[kTM][kTN]) {
#pragma unroll
  for (int kb = 0; kb < kBK; kb += 4) {
    if (!FULL && kb >= kn) break;
    float4 xv[kTM], av[kTN];
#pragma unroll
    for (int q = 0; q < kTM; ++q)
      xv[q] = *reinterpret_cast<const float4*>(xrows + 16 * q * kLDS + kb);
#pragma unroll
    for (int c = 0; c < kTN; ++c)
      av[c] = *reinterpret_cast<const float4*>(arows + 16 * c * kLDS + kb);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!FULL && kb + k >= kn) break;
#pragma unroll
      for (int q = 0; q < kTM; ++q) {
        const float x = k == 0 ? xv[q].x : k == 1 ? xv[q].y : k == 2 ? xv[q].z : xv[q].w;
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          const float u = k == 0 ? av[c].x : k == 1 ? av[c].y : k == 2 ? av[c].z : av[c].w;
          acc[q][c] = fmaf(x, u, acc[q][c]);
        }
      }
    }
  }
}

// Two blocks an SM: the shared memory allows no more.
template <int R>
__global__ void __launch_bounds__(kTiledThreads, 2)
knn_tiled_kernel(const float* __restrict__ X, const float* __restrict__ P, int n, int s, int d,
                 bool x_vec, int* __restrict__ idx_out, float* __restrict__ dist_out) {
  extern __shared__ __align__(16) float knn_tiled_smem[];
  auto xs = reinterpret_cast<float (*)[kBM][kLDS]>(knn_tiled_smem);
  auto as = reinterpret_cast<float (*)[kBN][kLDS]>(knn_tiled_smem + kStages * kBM * kLDS);
  auto u2s = reinterpret_cast<float (*)[kBN]>(knn_tiled_smem + kStages * (kBM + kBN) * kLDS);
  auto ds = reinterpret_cast<float (*)[kLDD]>(knn_tiled_smem +
                                               kStages * ((kBM + kBN) * kLDS + kBN));
  float* x2s = knn_tiled_smem + kStages * ((kBM + kBN) * kLDS + kBN) + kBM * kLDD;

  const int rec = tiled_rec(d);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  // the product: rows ty + 16q of the block, anchors tx + 16c of a tile; a
  // warp takes 4 neighbouring row groups and 8 neighbouring anchor groups
  const int tx = lane % 8 + 8 * (warp % 2);
  const int ty = lane / 8 + 4 * (warp / 2);
  // the selection: row rho of the block; in each run of 32 anchors of a
  // tile, the 4 at 4 * (sub % 2) + 16 * (sub / 2) and the 4 after the next 4
  const int rho = threadIdx.x / kLanesARow;
  const int sub = threadIdx.x % kLanesARow;
  const int sel_col = 4 * (sub % 2) + 16 * (sub / 2);
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;

  // |x|^2 of the block's rows, one thread a row, in feature order
  if (threadIdx.x < kBM) {
    const long long rw = row0 + threadIdx.x;
    float v = 0.0f;
    if (rw < n) {
      const float* x = X + static_cast<size_t>(rw) * d;
      for (int k = 0; k < d; ++k) v = __fadd_rn(v, __fmul_rn(x[k], x[k]));
    }
    x2s[threadIdx.x] = v;
  }

  // this block's share of the anchor tiles: a contiguous run, the runs of
  // a split as even as they can be
  const int ntiles = (s + kBN - 1) / kBN;
  const int t_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * ntiles / gridDim.y);
  const int nslabs = (d + kBK - 1) / kBK;
  const int steps = t_end > t_begin ? (t_end - t_begin) * nslabs : 0;

  // the copies of a slab: this thread's are the 4 features at 4 * cf of row
  // cr and of anchors cr and cr + 64, so only the slab's offsets change from
  // step to step
  const int cf = 4 * (threadIdx.x % 4);
  const int cr = threadIdx.x / 4;
  const bool x_ok = row0 + cr < n;
  const float* x_src = X + static_cast<size_t>(x_ok ? row0 + cr : 0) * d + cf;
  // the next step to load: its slab, its tile (from t_begin), the tile's
  // first anchor and records
  int ld_step = 0, ld_k0 = 0, ld_tile = 0, ld_j = t_begin * kBN;
  const float* ld_recs = P + static_cast<size_t>(ld_j) * rec;
  auto load_next = [&]() {
    const int buf = ld_step % kStages;
    const int k = ld_k0 + cf;
    // X: 16 bytes where the rows allow (d a multiple of 4), else 4 at a time
    if (x_vec) {
      const bool ok = x_ok && k < d;
      cp_async16(&xs[buf][cr][cf], ok ? x_src + ld_k0 : X, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = x_ok && k + e < d;
        cp_async4(&xs[buf][cr][cf + e], ok ? x_src + ld_k0 + e : X, ok);
      }
    }
    // the anchors: records are 16-byte aligned (tiled_rec), features past d
    // are not read
    const int bytes = 4 * max(0, min(4, d - k));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = cr + 64 * u;
      const bool ok = ld_j + c < s && bytes > 0;
      cp_async16(&as[buf][c][cf], ok ? ld_recs + static_cast<size_t>(c) * rec + k : P,
                 ok ? bytes : 0);
    }
    // |u|^2 of the tile's anchors, with its first slab, into the tile's
    // slot: tile t + kStages takes it when tile t's last slab is done
    if (ld_k0 == 0 && threadIdx.x < kBN) {
      const bool ok = ld_j + threadIdx.x < s;
      cp_async4(&u2s[ld_tile % kStages][threadIdx.x],
                ok ? ld_recs + static_cast<size_t>(threadIdx.x) * rec + rec - 1 : P, ok);
    }
    cp_async_commit();
    ++ld_step;
    ld_k0 += kBK;
    if (ld_k0 >= d) {
      ld_k0 = 0;
      ++ld_tile;
      ld_j += kBN;
      ld_recs += static_cast<size_t>(kBN) * rec;
    }
  };

  float acc[kTM][kTN];
  float bd[1][R];
  int bi[1][R];
  topr_init<R>(bd[0], bi[0]);
  // No list of the row can take a candidate above the smallest last entry of
  // its lanes' lists (one equal to it may still enter, with a lower index):
  // thr, refreshed after each tile.  A candidate enters this lane's list iff
  // it is below lim = min(last entry, the float after thr).
  float thr = CUDART_INF_F;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) {
      load_next();
    } else {
      cp_async_commit();   // an empty group keeps the count of groups uniform
    }
  }
  int slab = 0, tile = t_begin;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();   // step i's slab has landed
    __syncthreads();                // for every thread; and step i - 1's buffer is free
    if (i + kStages - 1 < steps) {
      load_next();
    } else {
      cp_async_commit();
    }
    const int buf = i % kStages;
    if (slab == 0) {
#pragma unroll
      for (int q = 0; q < kTM; ++q) {
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[q][c] = -0.0f;
      }
    }
    const float* xrows = &xs[buf][ty][0];
    const float* arows = &as[buf][tx][0];
    const int kn = min(kBK, d - slab * kBK);
    if (kn == kBK) {
      fma_slab<true>(xrows, arows, kBK, acc);
    } else {
      fma_slab<false>(xrows, arows, kn, acc);
    }
    if (++slab == nslabs) {
      // The tile's d^2 into shared memory; +inf past s, never in a list.  A
      // warp's writes land in 32 distinct banks (kLDD = 8 mod 32).
      const float* tile_u2 = u2s[(tile - t_begin) % kStages];
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        const int col = tx + 16 * c;
        const float u2 = tile * kBN + col < s ? tile_u2[col] : CUDART_INF_F;
#pragma unroll
        for (int q = 0; q < kTM; ++q) {
          ds[ty + 16 * q][col] = __fadd_rn(__fadd_rn(x2s[ty + 16 * q], acc[q][c]), u2);
        }
      }
      __syncthreads();
      // the selection, in increasing anchor order; a quarter warp's 16-byte
      // reads (2 rows x 4 lanes) fall in distinct bank groups
      float lim = fminf(bd[0][R - 1], nextafterf(thr, CUDART_INF_F));
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int col = 32 * h + sel_col;
        const float4 w0 = *reinterpret_cast<const float4*>(&ds[rho][col]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ds[rho][col + 8]);
        const float c8[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        float low = c8[0];
#pragma unroll
        for (int c = 1; c < 8; ++c) low = fminf(low, c8[c]);
        if (low < lim) {  // rare once the lists have filled
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if (c8[c] < lim) {
              topr_insert_flat<R>(bd[0], bi[0], c8[c], tile * kBN + col + c % 4 + 8 * (c / 4));
              lim = fminf(bd[0][R - 1], lim);
            }
          }
        }
      }
      thr = fminf(bd[0][R - 1], __shfl_xor_sync(0xffffffffu, bd[0][R - 1], 1));
      thr = fminf(thr, __shfl_xor_sync(0xffffffffu, thr, 2));
      slab = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();

  const long long row[1] = {row0 + rho};
  const size_t part = static_cast<size_t>(blockIdx.y) * n * R;
  merge_and_store<R, 1>(bd, bi, kLanesARow, sub, row, n, idx_out + part, dist_out + part);
}

// One row a thread: the `parts` sorted lists of a split merged in (d^2,
// index) order.  A list is sorted, so its first entry that does not beat the
// merged list's last one ends it.
template <int R>
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const float* __restrict__ pdist, const int* __restrict__ pidx, int n, int parts,
                 int* __restrict__ idx_out, float* __restrict__ dist_out) {
  const long long row = static_cast<long long>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (row >= n) return;
  const size_t base = static_cast<size_t>(row) * R;
  float bd[R];
  int bi[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    bd[k] = pdist[base + k];
    bi[k] = pidx[base + k];
  }
  for (int p = 1; p < parts; ++p) {
    const size_t off = static_cast<size_t>(p) * n * R + base;
#pragma unroll 1
    for (int k = 0; k < R; ++k) {
      const float cd = pdist[off + k];
      const int ci = pidx[off + k];
      if (!(cd < bd[R - 1] || (cd == bd[R - 1] && ci < bi[R - 1]))) break;
      topr_insert<R, true>(bd, bi, cd, ci);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    idx_out[base + k] = bi[k];
    dist_out[base + k] = bd[k];
  }
}

}  // namespace

int launch_tiled(const Args& a) {
  const int split = a.split > 0 ? a.split : 1;
  // a split's lists: split * n * r distances, then as many indices
  const size_t entries = static_cast<size_t>(split) * a.n * a.r;
  float* pdist = split > 1 ? a.part : a.dist;
  int* pidx = split > 1 ? reinterpret_cast<int*>(a.part + entries) : a.idx;
  // X's rows are 16-byte aligned when d is a multiple of 4 and X is
  const bool x_vec = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.X) % 16 == 0;
  cudaError_t err = cudaSuccess;
  switch (a.r) {
#define FLGP_KNN_CASE(R)                                                                      \
  case R: {                                                                                   \
    const dim3 grid((a.n + kBM - 1) / kBM, split);                                            \
    err = cudaFuncSetAttribute(knn_tiled_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               static_cast<int>(kSmemBytes));                                 \
    if (err != cudaSuccess) return static_cast<int>(err);                                     \
    knn_tiled_kernel<R><<<grid, kTiledThreads, kSmemBytes, a.stream>>>(a.X, a.P, a.n, a.s, a.d, \
                                                                       x_vec, pidx, pdist);   \
    err = cudaGetLastError();                                                                 \
    if (err == cudaSuccess && split > 1) {                                                    \
      knn_merge_kernel<R><<<(a.n + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,     \
                            a.stream>>>(pdist, pidx, a.n, split, a.idx, a.dist);              \
      err = cudaGetLastError();                                                               \
    }                                                                                         \
    break;                                                                                    \
  }
    FLGP_R_CASES(FLGP_KNN_CASE)
#undef FLGP_KNN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace flgp_k1
