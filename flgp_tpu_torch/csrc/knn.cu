// K1: brute-force r-nearest-anchor search.
//
// Replaces the TPU kernel flgp_tpu/ops/pallas_kernels.py:fused_knn
// (_knn_kernel): d = |x|^2 - 2 x.u + |u|^2 at full f32, then the r smallest
// per row, nearest first, ties to the lowest anchor index, for any
// 1 <= r <= s, as that kernel takes (r <= 16 is only the reference's
// dispatch, flgp_tpu/ops/knn.py).  The bodies of knn.cuh and knn_tiled.cu
// hold r in registers, a template parameter up to 16; every larger r takes
// the run-time-r body of knn_wide.cu (its own note).  This file holds the
// anchor pre-pass and the C entry point.
//
// What bounds it on the H100: at the paths' shapes (d = 2 or 3, s from 1024
// anchors to the 1e5 points of a self-kNN) each (row, anchor) pair costs d
// FMAs, two adds and a compare against a few bytes of input, so the kernel
// is bound by the SM's instruction rate, not by memory.
// The TPU kernel formed the (block, s) distance tile in VMEM and ran r
// masked row-min passes over it; here no tile exists at all.
//
// Design, all of it to spend fewer instructions a pair and to keep every SM
// busy:
//  * A pre-pass (knn_pack_kernel) writes each anchor once as a record
//    (-2u_0, ..., -2u_{d-1}, |u|^2) into scratch the wrapper allocates, so no
//    block recomputes a norm.  For d = 2 and 3 the record is one float4.
//  * d = 2 and d = 3 are template parameters (knn.cuh; knn_d2.cu, knn_d3.cu):
//    the rows of X live in registers, the feature loop is unrolled, and an
//    anchor is one 16-byte shared-memory read that every lane of a group
//    makes at the same address (a broadcast).  A thread owns 4 rows (2 when
//    r > 8), so that read and the loop's bookkeeping serve 4 pairs and the 4
//    FMA chains overlap.  Every other d takes the tiled body of
//    knn_tiled.cu (its own note): a GEMM's register tiling with the top-r
//    selection as its epilogue.
//  * Each thread keeps a sorted top-r list per row in registers (r is a
//    template parameter, 1 to 16).  A thread scans its anchors in
//    increasing index order and a candidate displaces a list entry only if
//    it is smaller in (d^2, index), so ties keep the lower index.  After the
//    first anchors the insertion is rare; the common pair is FMAs, two adds,
//    a compare and a branch not taken.
//  * Where the rows alone cannot fill the card (65,536 rows at 4 a thread
//    are 128 blocks on 132 SMs), `split` neighbouring lanes share a
//    thread's rows and divide the anchors of each tile between them
//    (lane q takes anchors q, q + split, ...: consecutive 16-byte records,
//    so no bank conflict), and a shuffle butterfly merges their lists in
//    (d^2, index) order: the same list, whatever the split.  The C entry
//    point chooses the split from (n, s).
//
// Rounding follows the plain version (ops/distance.py:sqdist) step by step
// so that near-ties break the same way: the norms are sums of rounded
// squares (no FMA contraction, as torch.sum(X * X) rounds each product), the
// cross term an FMA chain over the features, as a GEMM accumulates, and
// d^2 = (|x|^2 - 2 x.u) + |u|^2.  Scaling the anchors by -2 beforehand is
// exact (a power of two), so the chain gives -2 x.u with the very rounding
// of x.u; folding |x|^2 into the chain's start would not.
//
// How close to the bound: on an H100 (700 W) at n = 1e6, s = 1024, d = 2,
// r = 3 the kernel takes 0.56 ms against an operation bound of 0.092 ms, a
// sixth of it (chip_smoke.py prints both).  Two things stand between them.
// A pair is 4 floating-point instructions (multiply, FMA, two adds) that the
// bound counts as 6 operations at 2 a cycle-lane, plus the compare and a
// quarter of the shared-memory read and of the branch: the CUDA cores take
// one instruction a cycle-lane, so about half the bound is the most this
// formulation can reach, and the tensor cores do not help (a depth-2 product
// in exact float32 has no tensor-core form).  The other half of the time is
// the insertion: a row inserts about r ln(s / r) times, but a warp runs the
// insertion whenever any of its 32 lanes does, which at s = 1024 and r = 3
// is at a third of its anchors.  With 1e5 anchors (the self-kNN) that share
// is small, and with r = 1 the insertion is two moves.  PERF.md has the times.

#include "knn.cuh"

namespace flgp_k1 {
namespace {

// threads the card should have in flight before rows stop being split
// (132 SMs x 256), and the fewest anchors a lane of a split group scans
constexpr long long kFillThreads = 132LL * 256;
constexpr int kMinAnchorsPerLane = 32;

// One anchor a thread: record j is rec floats, (-2u_0 .. -2u_{d-1}, 0.., |u|^2).
__global__ void knn_pack_kernel(const float* __restrict__ U, int s, int d, int rec,
                                float* __restrict__ P) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s) return;
  const float* u = U + static_cast<size_t>(j) * d;
  float* p = P + static_cast<size_t>(j) * rec;
  float u2 = 0.0f;
  for (int k = 0; k < d; ++k) {
    u2 = __fadd_rn(u2, __fmul_rn(u[k], u[k]));
    p[k] = -2.0f * u[k];
  }
  for (int k = d; k < rec - 1; ++k) p[k] = 0.0f;
  p[rec - 1] = u2;
}

// The fewest lanes a row (power of two, at most a warp) that put
// kFillThreads threads in flight, while a lane still has anchors to scan.
int choose_split(int n, int s, int rows_a_thread) {
  const long long slots = (static_cast<long long>(n) + rows_a_thread - 1) / rows_a_thread;
  int g = 1;
  while (g < 32 && slots * g < kFillThreads && s / (2 * g) >= kMinAnchorsPerLane) g *= 2;
  return g;
}

}  // namespace
}  // namespace flgp_k1

// X (n, d) f32, U (s, d) f32 -> idx (n, r) i32, dist (n, r) f32; 1 <= r <= s.
// scratch: s * tiled_rec(max(d, 3)) floats for the packed anchors.  The
// bodies: r <= 16 takes a templated body unless `runtime_r` is set, the
// template bodies of knn.cuh at d = 2 and 3 and the tiled body of
// knn_tiled.cu at every other d; every r > 16 (and any r with `runtime_r`)
// takes the run-time-r body of knn_wide.cu, at every d, and `lists` then
// holds flgp_knn_wide_lists(n, r, split) words of its merge temps (none
// needed where that is 0).  split: for the template bodies the lanes that
// share a row, 0 letting the entry point choose; for the tiled and
// run-time-r bodies the blocks that divide a row block's anchors (0 means
// 1), with `part` holding 2 * split * n * r words of their lists when
// split > 1.  The tests pass 1, 2, ..., 32 to force a path.
extern "C" int flgp_knn(const void* X, const void* U, int n, int s, int d, int r, int split,
                        int runtime_r, void* scratch, void* part, void* lists, void* idx,
                        void* dist, void* stream) {
  using namespace flgp_k1;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const bool wide = r > kTemplatedMaxR || runtime_r != 0;
  const bool fixed = !wide && (d == 2 || d == 3);
  if (s <= 0 || d <= 0 || r < 1 || r > s || split < 0 || split > 32 ||
      (split & (split - 1)) != 0 || (!fixed && split > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.X = static_cast<const float*>(X);
  a.P = static_cast<const float*>(scratch);
  a.n = n;
  a.s = s;
  a.d = d;
  a.r = r;
  a.split = split ? split : fixed ? choose_split(n, s, rows_per_thread(r)) : 1;
  a.part = static_cast<float*>(part);
  a.lists = static_cast<float*>(lists);
  a.idx = static_cast<int*>(idx);
  a.dist = static_cast<float*>(dist);
  a.stream = static_cast<cudaStream_t>(stream);

  // tiled_rec(2) = tiled_rec(3) = 4: the template bodies' float4 records
  const int rec = tiled_rec(d);
  knn_pack_kernel<<<(s + 255) / 256, 256, 0, a.stream>>>(static_cast<const float*>(U), s, d, rec,
                                                         static_cast<float*>(scratch));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (wide) return launch_wide(a);
  return fixed ? (d == 2 ? launch_d2(a) : launch_d3(a)) : launch_tiled(a);
}
