// K1's run-time-r body: the r nearest anchors at any 1 <= r <= s, every d.
//
// Replaces, with knn.cu (the entry point flgp_knn, the anchor pre-pass and
// the rounding rule), the TPU kernel flgp_tpu/ops/pallas_kernels.py:fused_knn
// (_knn_kernel :50, pallas_call :99) at the fan-ins above the templated
// bodies' 16.  That kernel takes any r <= s; r <= 16 is only the reference's
// dispatch (flgp_tpu/ops/knn.py).  The paths' wide fan-ins: the r = 24
// graphs, and the GLGP self-kNN at the default threshold, r = 0.01 n (48 on
// the torus, 1000 at n = 1e5).  flgp_knn sends every r > 16 here, and any r
// when `runtime_r` is set (the tests' and chip_smoke.py's check against the
// templated bodies' bits).
//
// What bounds it on the H100: as the tiled body, n*s*(2d + 2) float32
// operations against 4(n + s)d + 8nr bytes, the CUDA cores' rate at every
// shape the paths use.  The TPU kernel selected with r masked row-min passes
// over each distance tile, r times the distance work; here a pair costs one
// compare unless its d^2 beats the row's current r-th.
//
// Design:
//  * Distances: the tiled body's product (knn_tiled.cuh) at every d, 2 and 3
//    included, one body for all: 64 rows a block, anchor tiles of 128, a
//    4 x 8 tile of FMA chains a thread, each tile's d^2 written to shared
//    memory.  The rounding rule of knn.cu, so d^2 is the templated bodies'
//    bits and so is the list.  The loop over the slabs repeats the tiled
//    body's own: that templated body keeps its text, since routing a
//    templated body through shared code slowed it by some 4% before.
//  * Selection, a warp for 8 of the block's rows, one row at a time.  A row
//    keeps a sorted list of its best (d^2, index) pairs so far, at most r,
//    and tau, the list's r-th d^2 (+inf until it holds r).  Its first tile
//    fills the list at once: the warp sorts the tile's 128 pairs in
//    registers (4 a lane) and keeps the first r (above r = 32; below, the
//    buffer's flushes cost less).  Otherwise the warp reads the row's 128
//    d^2 32 at a time, a lane an anchor, and the lanes whose d^2 is below
//    tau append it to the row's staging buffer in shared memory (a ballot
//    and a prefix count).  Anchors come in increasing index order, so one
//    whose d^2 equals tau ranks behind the list's r-th and is out.
//  * When 32 more could overflow the buffer (`stage` = 32 E entries, E = 1,
//    2, 4 or 8 slots a lane, the least with 32 E >= r), and at the end, the
//    warp flushes it, all in registers: a bitonic sort of the staged pairs,
//    E a lane, exchanged by shuffles, each pair one 64-bit key (d^2's bits
//    made monotone, then the index: one integer compare a step); then,
//    where the list fits the same 32 E slots (r <= 256), a bitonic merge
//    with it (the list against the reversed buffer, elementwise, then
//    log2(32 E) steps).  Above r = 256 the sorted buffer goes back to shared
//    memory and a merge-path merge writes the first r of the two into the
//    warp's temp, copied back.  tau is then the new r-th.
//  * The flushes are most of the time, and a warp that flushes holds its
//    block at the next tile's barrier.  So a warp first scans its rows only
//    up to a full buffer; rows whose buffer filled go to a queue of the
//    block, and every warp takes rows from it (an atomic head) to flush and
//    finish: a tile's flushes spread over the block's 8 warps.
//  * The lists live in shared memory where 64 of them fit beside the
//    product's buffers and the staging (r up to ~130), else in the output
//    itself.  Above r = 256 the warps' merge temps live in scratch that the
//    wrapper allocates (flgp_knn_wide_lists words).
//  * The anchor split (`split` blocks divide a row block's anchor tiles,
//    blockIdx.y) as in the tiled body, each block's lists in `part`; then
//    knn_wide_merge_kernel merges a row's lists, a warp a row and a lane a
//    list, in (d^2, index) order: the same list whatever the split.  A block
//    whose share holds fewer than r anchors pads its list with (+inf,
//    INT_MAX), which sorts last.
//  * What bounds the selection inside a flush, instruction throughput or the
//    latency of its chains of shuffles, is not measured (no ncu on the
//    card's machine).
//    Tried and dropped, each slower at r = 24: E = 2 slots a lane (one block
//    an SM), four rows' flushes interleaved, and a first-tile threshold from
//    the lanes' minima.  The first body sorted and merged in shared memory,
//    a __syncwarp a step: 1.145 ms at the n=1e7 chunk, r = 24
//    (chip_smoke.py, H100 80GB HBM3 at 700 W), against 0.081 for the r = 3
//    body.  PERF.md section 6 has this body's times.

#include <cstdint>

#include "knn_tiled.cuh"

namespace flgp_k1 {
namespace {

constexpr int kWideWarps = kTiledThreads / 32;
constexpr int kRowsAWarp = kBM / kWideWarps;     // selection rows a warp
constexpr int kMaxSlots = 8;                     // staged pairs a lane: stage <= 256
constexpr int kMergeWarps = 8;
// the rows' tau, staged counts and list lengths; the tile's queue of rows
// to flush (row, chunk), its length and its head
constexpr size_t kRowStateBytes = (5 * kBM + 4) * sizeof(float);
static_assert(kBM == kWideWarps * kRowsAWarp, "whole rows a warp");
static_assert(kBN == 4 * 32, "a tile row is 4 pairs a lane");

struct WideLayout {
  int slots;          // E: staged pairs a lane, stage = 32 E
  bool smem_lists;    // the lists in shared memory
  bool temps;         // r > 32 E: merge-path flushes through global temps
  size_t smem;        // dynamic shared memory a block
};

WideLayout wide_layout(int r) {
  WideLayout w;
  w.slots = 1;
  while (32 * w.slots < r && w.slots < kMaxSlots) w.slots *= 2;
  const size_t base = kSmemBytes + kRowStateBytes + static_cast<size_t>(kBM) * 32 * w.slots * 8;
  const size_t lists = static_cast<size_t>(kBM) * r * 8;
  w.smem_lists = base + lists <= kMaxBlockSmem;
  w.temps = r > 32 * w.slots;
  w.smem = base + (w.smem_lists ? lists : 0);
  return w;
}

// (da, ia) comes before (db, ib): d^2 first, then the lower index
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// A (d^2, index) pair as one 64-bit key whose unsigned order is that order:
// d^2's bits made monotone (sign bit set for d^2 >= 0, every bit flipped
// below; + 0.0f turns a -0 into +0, which compares equal to it), the index
// below.  kPad, past every real pair, fills empty slots.
constexpr unsigned long long kPad = ~0ull;

__device__ __forceinline__ unsigned long long pack(float d, int i) {
  const unsigned b = __float_as_uint(d + 0.0f);
  const unsigned o = b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) | static_cast<unsigned>(i);
}

__device__ __forceinline__ float key_d(unsigned long long k) {
  const unsigned o = static_cast<unsigned>(k >> 32);
  return __uint_as_float(o ^ ((o >> 31) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ int key_i(unsigned long long k) {
  return static_cast<int>(static_cast<unsigned>(k));
}

// One step of a bitonic network over a warp's 32 E keys, key i = lane +
// 32 e in slot e: pairs (i, i ^ j) ordered ascending where i & k is 0,
// descending elsewhere.  j >= 32 pairs two slots of a lane; j < 32 two lanes,
// each keeping its end of the pair.  Real keys are distinct; kPad may meet
// itself.
template <int E>
__device__ __forceinline__ void bitonic_step(unsigned long long (&v)[E], int k, int j, int lane) {
  if (j >= 32) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int f = e ^ (j >> 5);
      if (f < e) continue;
      const bool up = ((lane + 32 * e) & k) == 0;
      if ((v[f] < v[e]) == up) {
        const unsigned long long t = v[e];
        v[e] = v[f];
        v[f] = t;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned long long p = __shfl_xor_sync(0xffffffffu, v[e], j);
      const bool up = ((lane + 32 * e) & k) == 0;
      const bool first = ((lane & j) == 0) == up;  // this lane keeps the pair's first
      if ((p < v[e]) == first) v[e] = p;
    }
  }
}

// Sorts the warp's 32 E keys ascending.
template <int E>
__device__ __forceinline__ void warp_sort(unsigned long long (&v)[E], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) bitonic_step<E>(v, k, j, lane);
  }
}

// d^2 of key i of the warp's slots (any lane may ask; i < 32 E)
template <int E>
__device__ __forceinline__ float slot_d(const unsigned long long (&v)[E], int i) {
  unsigned long long w = v[0];
#pragma unroll
  for (int e = 1; e < E; ++e) {
    if (e == (i >> 5)) w = v[e];
  }
  return key_d(__shfl_sync(0xffffffffu, w, i & 31));
}

// The warp merges a row's `count` staged pairs (sd, si) into its sorted
// list (ld, li) of `len` pairs, keeping the first m = min(r, len + count);
// returns m and sets tau.  See the note at the top.
template <int E>
__device__ int flush_row(float* sd, int* si, int count, float* ld, int* li, int len, float* td,
                         int* ti, int r, int lane, float& tau) {
  __syncwarp();  // the appends of every lane are in
  unsigned long long v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + 32 * e;
    v[e] = i < count ? pack(sd[i], si[i]) : kPad;
  }
  warp_sort<E>(v, lane);
  const int m = min(r, len + count);
  if (E < kMaxSlots || r <= 32 * E) {
    // the list in the same slots, against the reversed buffer (key i
    // against key 32 E - 1 - i): the 32 E least of the two, bitonic; then
    // sorted
    unsigned long long rv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) rv[e] = __shfl_sync(0xffffffffu, v[E - 1 - e], 31 - lane);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + 32 * e;
      const unsigned long long o = i < len ? pack(ld[i], li[i]) : kPad;
      v[e] = o < rv[e] ? o : rv[e];
    }
#pragma unroll
    for (int j = 16 * E; j > 0; j >>= 1) bitonic_step<E>(v, 64 * E, j, lane);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + 32 * e;
      if (i < m) {
        ld[i] = key_d(v[e]);
        li[i] = key_i(v[e]);
      }
    }
    tau = m == r ? slot_d<E>(v, r - 1) : CUDART_INF_F;
  } else {
    // r > 256: the sorted buffer back to shared memory, then merge path
#pragma unroll
    for (int e = 0; e < E; ++e) {
      sd[lane + 32 * e] = key_d(v[e]);
      si[lane + 32 * e] = key_i(v[e]);
    }
    __syncwarp();
    const int q = (m + 31) / 32;
    const int k0 = min(m, lane * q);
    const int k1 = min(m, k0 + q);
    if (k0 < k1) {
      int lo = max(0, k0 - count), hi = min(k0, len);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(ld[mid], li[mid], sd[k0 - 1 - mid], si[k0 - 1 - mid])) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      int a = lo, b = k0 - lo;
      for (int k = k0; k < k1; ++k) {
        if (b >= count || (a < len && before(ld[a], li[a], sd[b], si[b]))) {
          td[k] = ld[a];
          ti[k] = li[a];
          ++a;
        } else {
          td[k] = sd[b];
          ti[k] = si[b];
          ++b;
        }
      }
    }
    __syncwarp();
    for (int k = lane; k < m; k += 32) {
      ld[k] = td[k];
      li[k] = ti[k];
    }
    __syncwarp();
    tau = m == r ? ld[r - 1] : CUDART_INF_F;
  }
  __syncwarp();  // every lane is past its reads of the buffer
  return m;
}

// Two blocks an SM where the shared memory allows (E = 1: r up to 29).
template <int E>
__global__ void __launch_bounds__(kTiledThreads, E == 1 ? 2 : 1)
knn_wide_kernel(const float* __restrict__ X, const float* __restrict__ P, int n, int s, int d,
                int r, bool x_vec, bool smem_lists, float* __restrict__ temps,
                int* __restrict__ idx_out, float* __restrict__ dist_out) {
  constexpr int kStage = 32 * E;
  extern __shared__ __align__(16) float knn_wide_smem[];
  auto xs = reinterpret_cast<float (*)[kBM][kLDS]>(knn_wide_smem);
  auto as = reinterpret_cast<float (*)[kBN][kLDS]>(knn_wide_smem + kStages * kBM * kLDS);
  auto u2s = reinterpret_cast<float (*)[kBN]>(knn_wide_smem + kStages * (kBM + kBN) * kLDS);
  auto ds = reinterpret_cast<float (*)[kLDD]>(knn_wide_smem +
                                               kStages * ((kBM + kBN) * kLDS + kBN));
  float* x2s = knn_wide_smem + kStages * ((kBM + kBN) * kLDS + kBN) + kBM * kLDD;
  // the rows' state, their staging buffers and (smem_lists) their lists
  float* tau_s = knn_wide_smem + kSmemBytes / sizeof(float);
  int* count_s = reinterpret_cast<int*>(tau_s + kBM);
  int* len_s = count_s + kBM;
  int* q_row = len_s + kBM;
  int* q_chunk = q_row + kBM;
  int* q_n = q_chunk + kBM;  // and q_n[1]: the queue's head
  float* stage_d = reinterpret_cast<float*>(q_n + 4);
  int* stage_i = reinterpret_cast<int*>(stage_d + kBM * kStage);
  float* list_d = reinterpret_cast<float*>(stage_i + kBM * kStage);
  int* list_i = reinterpret_cast<int*>(list_d + kBM * r);

  const int rec = tiled_rec(d);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  // the product, as the tiled body: rows ty + 16q, anchors tx + 16c
  const int tx = lane % 8 + 8 * (warp % 2);
  const int ty = lane / 8 + 4 * (warp / 2);
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  // this block's lists of a split
  const size_t part = static_cast<size_t>(blockIdx.y) * n * r;
  // the warp's merge temp (r > 256 only)
  const size_t wslot =
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kWideWarps + warp;
  float* td = temps == nullptr ? nullptr : temps + wslot * 2 * r;
  int* ti = td == nullptr ? nullptr : reinterpret_cast<int*>(td + r);
  // row rho's list: shared memory, or its place in the output
  auto list_of = [&](int rho, float*& ld, int*& li) {
    if (smem_lists) {
      ld = list_d + rho * r;
      li = list_i + rho * r;
    } else {
      const size_t at = part + static_cast<size_t>(row0 + rho) * r;
      ld = dist_out + at;
      li = idx_out + at;
    }
  };

  // |x|^2 of the block's rows, one thread a row, in feature order
  if (threadIdx.x < kBM) {
    const long long rw = row0 + threadIdx.x;
    float v = 0.0f;
    if (rw < n) {
      const float* x = X + static_cast<size_t>(rw) * d;
      for (int k = 0; k < d; ++k) v = __fadd_rn(v, __fmul_rn(x[k], x[k]));
    }
    x2s[threadIdx.x] = v;
    tau_s[threadIdx.x] = CUDART_INF_F;
    count_s[threadIdx.x] = 0;
    len_s[threadIdx.x] = 0;
  }

  const int ntiles = (s + kBN - 1) / kBN;
  const int t_begin = static_cast<int>(static_cast<long long>(blockIdx.y) * ntiles / gridDim.y);
  const int t_end = static_cast<int>(static_cast<long long>(blockIdx.y + 1) * ntiles / gridDim.y);
  const int nslabs = (d + kBK - 1) / kBK;
  const int steps = t_end > t_begin ? (t_end - t_begin) * nslabs : 0;

  const int cf = 4 * (threadIdx.x % 4);
  const int cr = threadIdx.x / 4;
  const bool x_ok = row0 + cr < n;
  const float* x_src = X + static_cast<size_t>(x_ok ? row0 + cr : 0) * d + cf;
  int ld_step = 0, ld_k0 = 0, ld_tile = 0, ld_j = t_begin * kBN;
  const float* ld_recs = P + static_cast<size_t>(ld_j) * rec;
  auto load_next = [&]() {
    const int buf = ld_step % kStages;
    const int k = ld_k0 + cf;
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
    const int bytes = 4 * max(0, min(4, d - k));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = cr + 64 * u;
      const bool ok = ld_j + c < s && bytes > 0;
      cp_async16(&as[buf][c][cf], ok ? ld_recs + static_cast<size_t>(c) * rec + k : P,
                 ok ? bytes : 0);
    }
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
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) {
      load_next();
    } else {
      cp_async_commit();
    }
  }
  int slab = 0, tile = t_begin;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
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
      // the tile's d^2, +inf past s
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
      if (threadIdx.x == 0) {
        q_n[0] = 0;
        q_n[1] = 0;
      }
      __syncthreads();
      // row rho's pairs of this tile from chunk h on (32 anchors, a lane
      // each) into its buffer; where the next 32 would overflow it, flush
      // it if `flush` is set, else stop there: returns the chunk it stopped
      // at, kBN / 32 when done
      auto scan_row = [&](int rho, int h, bool flush) {
        float* ld;
        int* li;
        list_of(rho, ld, li);
        float tau = tau_s[rho];
        int count = count_s[rho];
        float* sd = stage_d + rho * kStage;
        int* si = stage_i + rho * kStage;
        float v[kBN / 32];
#pragma unroll
        for (int c = 0; c < kBN / 32; ++c) v[c] = ds[rho][32 * c + lane];
        int stop = kBN / 32;
#pragma unroll
        for (int c = 0; c < kBN / 32; ++c) {
          if (c < h || stop < kBN / 32) continue;
          bool in = v[c] < tau;
          unsigned ball = __ballot_sync(0xffffffffu, in);
          if (ball == 0) continue;
          if (count + __popc(ball) > kStage) {
            if (!flush) {
              stop = c;
              continue;
            }
            const int len = flush_row<E>(sd, si, count, ld, li, len_s[rho], td, ti, r, lane, tau);
            count = 0;
            if (lane == 0) {
              len_s[rho] = len;
              tau_s[rho] = tau;
            }
            in = v[c] < tau;
            ball = __ballot_sync(0xffffffffu, in);
          }
          if (in) {
            const int at = count + __popc(ball & ((1u << lane) - 1u));
            sd[at] = v[c];
            si[at] = tile * kBN + 32 * c + lane;
          }
          count += __popc(ball);
        }
        if (lane == 0) count_s[rho] = count;
        return stop;
      };
      // the selection, first this warp's rows up to a full buffer; the rows
      // whose buffer filled go to the block's queue
      for (int t = 0; t < kRowsAWarp; ++t) {
        const int rho = warp * kRowsAWarp + t;
        if (row0 + rho >= n) break;  // and every later row of the warp
        if (r > 32 && tile == t_begin) {
          // a first tile of a wide list: its 128 pairs sorted, the first r
          // kept (below r = 32 the buffer's flushes cost less)
          float* ld;
          int* li;
          list_of(rho, ld, li);
          unsigned long long fv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) fv[e] = pack(ds[rho][lane + 32 * e], tile * kBN + lane + 32 * e);
          warp_sort<4>(fv, lane);
          const int len = min(r, min(kBN, s - tile * kBN));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (lane + 32 * e < len) {
              ld[lane + 32 * e] = key_d(fv[e]);
              li[lane + 32 * e] = key_i(fv[e]);
            }
          }
          const float tau = len == r ? slot_d<4>(fv, r - 1) : CUDART_INF_F;
          if (lane == 0) {
            len_s[rho] = len;
            tau_s[rho] = tau;
          }
          continue;
        }
        const int h = scan_row(rho, 0, false);
        if (h < kBN / 32 && lane == 0) {
          const int q = atomicAdd(q_n, 1);
          q_row[q] = rho;
          q_chunk[q] = h;
        }
      }
      __syncthreads();
      // then the queue, a row at a time to whichever warp is free: its
      // flush, and the rest of its tile
      for (;;) {
        int item = 0;
        if (lane == 0) item = atomicAdd(q_n + 1, 1);
        item = __shfl_sync(0xffffffffu, item, 0);
        if (item >= q_n[0]) break;
        scan_row(q_row[item], q_chunk[item], true);
      }
      slab = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rows' state, also where this block had no tile

  // the last flush, then the list into the output, padded past its length
  for (int t = 0; t < kRowsAWarp; ++t) {
    const int rho = warp * kRowsAWarp + t;
    if (row0 + rho >= n) break;
    float* ld;
    int* li;
    list_of(rho, ld, li);
    int len = len_s[rho];
    const int count = count_s[rho];
    if (count > 0) {
      float tau;
      len = flush_row<E>(stage_d + rho * kStage, stage_i + rho * kStage, count, ld, li, len, td,
                         ti, r, lane, tau);
    }
    const size_t at = part + static_cast<size_t>(row0 + rho) * r;
    for (int k = lane; k < r; k += 32) {
      if (k >= len) {
        dist_out[at + k] = CUDART_INF_F;
        idx_out[at + k] = INT_MAX;
      } else if (smem_lists) {
        dist_out[at + k] = ld[k];
        idx_out[at + k] = li[k];
      }
    }
  }
}

// A row's `parts` sorted lists of a split merged in (d^2, index) order, a
// warp a row: lane p holds the head of list p, a butterfly of shuffles finds
// the least head, and its lane moves on.
__global__ void __launch_bounds__(32 * kMergeWarps)
knn_wide_merge_kernel(const float* __restrict__ pdist, const int* __restrict__ pidx, int n,
                      int r, int parts, int* __restrict__ idx_out,
                      float* __restrict__ dist_out) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kMergeWarps + threadIdx.x / 32;
  if (row >= n) return;  // the whole warp
  const size_t mine = static_cast<size_t>(lane) * n * r + static_cast<size_t>(row) * r;
  const size_t out = static_cast<size_t>(row) * r;
  int pos = 0;
  float hd = CUDART_INF_F;
  int hi = INT_MAX;
  if (lane < parts) {
    hd = pdist[mine];
    hi = pidx[mine];
  }
  for (int k = 0; k < r; ++k) {
    float bd = hd;
    int bi = hi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (before(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    if (lane == 0) {
      idx_out[out + k] = bi;
      dist_out[out + k] = bd;
    }
    if (lane < parts && hi == bi && hd == bd) {
      ++pos;
      hd = pos < r ? pdist[mine + pos] : CUDART_INF_F;
      hi = pos < r ? pidx[mine + pos] : INT_MAX;
    }
  }
}

}  // namespace

int launch_wide(const Args& a) {
  const WideLayout w = wide_layout(a.r);
  if (w.temps && a.lists == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int split = a.split > 0 ? a.split : 1;
  const size_t entries = static_cast<size_t>(split) * a.n * a.r;
  float* pdist = split > 1 ? a.part : a.dist;
  int* pidx = split > 1 ? reinterpret_cast<int*>(a.part + entries) : a.idx;
  const bool x_vec = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.X) % 16 == 0;
  float* temps = w.temps ? a.lists : nullptr;
  const dim3 grid((a.n + kBM - 1) / kBM, split);
  cudaError_t err = cudaSuccess;
  switch (w.slots) {
#define FLGP_KNN_WIDE_CASE(E)                                                                 \
  case E:                                                                                     \
    err = cudaFuncSetAttribute(knn_wide_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                               static_cast<int>(w.smem));                                     \
    if (err != cudaSuccess) return static_cast<int>(err);                                     \
    knn_wide_kernel<E><<<grid, kTiledThreads, w.smem, a.stream>>>(                            \
        a.X, a.P, a.n, a.s, a.d, a.r, x_vec, w.smem_lists, temps, pidx, pdist);               \
    break;
    FLGP_KNN_WIDE_CASE(1)
    FLGP_KNN_WIDE_CASE(2)
    FLGP_KNN_WIDE_CASE(4)
    FLGP_KNN_WIDE_CASE(8)
#undef FLGP_KNN_WIDE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess && split > 1) {
    knn_wide_merge_kernel<<<(a.n + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0,
                            a.stream>>>(pdist, pidx, a.n, a.r, split, a.idx, a.dist);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace flgp_k1

// Words of global scratch K1's run-time-r body needs for its warps' merge
// temps at (n, r, split): 0 up to r = 256, where it merges in registers.
extern "C" long long flgp_knn_wide_lists(int n, int r, int split) {
  using namespace flgp_k1;
  if (n <= 0 || r < 1 || !wide_layout(r).temps) return 0;
  const long long blocks = static_cast<long long>((n + kBM - 1) / kBM) * (split > 1 ? split : 1);
  return blocks * kWideWarps * 2LL * r;
}
