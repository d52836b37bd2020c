// K9: raw ELL product out = Z @ W,  out[i, :] = sum_k vals[i, k] * W[idx[i, k], :],
// and the symmetric operator product built on it,
//   out[i, :] = sum_k vals[i, k] * X[idx[i, k], :]  +  sum_{e in in(i)} vt[e] * X[src[e], :],
// where in(i) = [ptr[i], ptr[i+1]) is row i of the graph's transpose as CSR.
//
// ell_matmat replaces the TPU kernel ell_matmat (_ell_matmat_kernel) in
// flgp_tpu/ops/pallas_kernels.py; its caller is EllMatrix.matmat
// (spectrum_from_Z).  ell_sym_matmat is the whole product (Z + Z^T) X of
// the sparse GLGP operator that LOBPCG applies once per iteration (s = n, X
// the (n, 3K) search block): what flgp_tpu/ops/sparse_graph.py:SymCoo.matvec
// sums over its 2nr-edge list, here as two gathers in one launch, one write
// of the result, no atomics and no weighted copy of X.  The CSR may hold any
// part of the transpose: ops/sparse_graph.py leaves out the entries whose
// reverse edge the graph holds too (most of a kNN graph's) and adds their
// values to the forward weights, which saves their gathers.
//
// What bounds it on the H100: memory.  Per row it reads 8r bytes of graph,
// gathers r rows of W (4K bytes each) and writes 4K bytes; 2rK flops against
// (r + 1) * 4K bytes is far below the f32 roofline ridge.  When s * K * 4
// exceeds what the 50 MB L2 keeps (the operator at n = 1e5, K = 384: 154 MB)
// a gathered row comes from device memory nearly every time it is named, r
// times instead of once.  When W does fit (n = 4800), the time is latency:
// a chain of dependent loads per row.
//
// Design:
//  * Column slabs that live in the L2.  K is walked in slabs of kSlabCols
//    columns and the slab is the slow part of the block index, so every row
//    block of one slab runs before the next slab starts: the slab of W
//    (s * kSlabCols * 4 bytes) stays in the L2 and each of its bytes leaves
//    device memory about once.  The graph is read once per slab, which is
//    small beside W.  No slabs when all of W fits (kL2ResidentBytes); the
//    forward product then takes the light one-warp-a-row kernel.  Every
//    fit of the package hands ell_matmat such a W (spectrum_from_Z: s is
//    the anchor count, s * K * 4 a few hundred kB), so on the fits' paths
//    the gather kernel below runs for ell_sym_matmat alone; its forward-only
//    instances serve a direct EllMatrix.matmat on a W beyond the L2.
//  * No dependent index loads in the inner loop.  A group of L lanes (4 to
//    32, by the slab's width) owns a row: lane a loads entry a of the row's
//    indices and weights (rounds of L when there are more) and a shuffle
//    hands them round, so the gathers of a round depend on nothing but the
//    shuffle.  A lane owns up to kMaxGroups column groups of the slab (16
//    bytes each when K is a multiple of 4 and the buffers are 16-byte
//    aligned, else 4), L apart, so a group's read of a W row is contiguous;
//    four entries' loads are started together before their FMAs.
//  * The transposed part loops to ptr[i+1]: in-degrees vary (hubs), and a
//    row with none adds nothing.
//  * The fmaf chain runs over k = 0..r-1, then over the transposed entries
//    in CSR order; size_t offsets; no atomics: the result is deterministic.
//    An index outside [0, s) contributes nothing; zero weights are not
//    dropped (this is the raw product).  out must not alias W.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 4;                       // column groups a lane owns
constexpr int kBatch = 4;                           // entries whose loads are started together
constexpr int kSlabCols = 64;                       // slab width when W does not fit in the L2
constexpr size_t kL2ResidentBytes = 32u << 20;      // W up to this size needs no slabs

__device__ __forceinline__ float vzero(const float*) { return 0.0f; }
__device__ __forceinline__ float4 vzero(const float4*) { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void vfma(float& acc, float w, float x) { acc = fmaf(w, x, acc); }
__device__ __forceinline__ void vfma(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// acc[g] += sum_e vals[e] * W[cols[e], kk[g]] over e = 0..count-1, in order.
// Every lane of the group (mask; first lane lane0, L lanes, this one lig)
// calls it with the same arguments.
template <typename V, int NG>
__device__ __forceinline__ void gather_entries(const V* __restrict__ W, size_t KV, int s,
                                               const int* __restrict__ cols,
                                               const float* __restrict__ vals, int count, int L,
                                               int lig, int lane0, unsigned mask,
                                               const int (&kk)[NG], int kend, V (&acc)[NG]) {
  for (int e0 = 0; e0 < count; e0 += L) {
    int c = -1;
    float v = 0.0f;
    if (e0 + lig < count) {
      c = cols[e0 + lig];
      v = vals[e0 + lig];
      if (c < 0 || c >= s) c = -1;
    }
    // lanes past the round's end hold c = -1, so the batches need no tail
    const int m = min(L, count - e0);
    for (int a = 0; a < m; a += kBatch) {
      V x[kBatch][NG];
      float w[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int col = __shfl_sync(mask, c, lane0 + a + u);
        w[u] = __shfl_sync(mask, v, lane0 + a + u);
        const V* row = W + static_cast<size_t>(col < 0 ? 0 : col) * KV;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          // a lane past the slab's end reads the slab's last group and
          // stores nothing: no predicate on the address
          x[u][g] = col >= 0 ? row[min(kk[g], kend - 1)] : vzero(row);
        }
        if (col < 0) w[u] = 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int g = 0; g < NG; ++g) vfma(acc[g], w[u], x[u][g]);
      }
    }
  }
}

// W resident in the L2, no transpose: one warp a row, lanes stride the
// columns, the row's entries read straight from the graph (every lane the
// same address).  32 registers a thread, so an SM holds 64 warps: with W in
// the L2 the kernel streams the graph in and the result out, and it is the
// number of rows in flight that hides their latency.  The slab kernel below,
// at twice the registers, is 1.3x slower on an H100 at n = 1e6, s = 1024,
// r = 3, K = 128 (chip_smoke.py times both there).
template <typename V>
__global__ void __launch_bounds__(kThreads)
ell_row_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
               const V* __restrict__ W, int n, int r, int s, int KV, V* __restrict__ out) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* v = vals + static_cast<size_t>(row) * r;
  const int* c = idx + static_cast<size_t>(row) * r;
  V* o = out + static_cast<size_t>(row) * KV;
  for (int k = lane; k < KV; k += 32) {
    V acc = vzero(W);
#pragma unroll 4
    for (int a = 0; a < r; ++a) {
      const int col = c[a];
      if (col >= 0 && col < s) vfma(acc, v[a], W[static_cast<size_t>(col) * KV + k]);
    }
    o[k] = acc;
  }
}

// Block b works on slab b / row_blocks (columns [slab * slabV, +slabV) in
// units of V) and rows [(b % row_blocks) * kThreads / L, ...), a group of L
// lanes a row.
template <typename V, int NG, bool SYM>
__global__ void __launch_bounds__(kThreads)
ell_gather_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                  const int* __restrict__ ptr, const int* __restrict__ src,
                  const float* __restrict__ vt, const V* __restrict__ W, int n, int r, int s,
                  int KV, int slabV, int L, int row_blocks, V* __restrict__ out) {
  const int slab = blockIdx.x / row_blocks;
  const int rb = blockIdx.x - slab * row_blocks;
  const int lane = threadIdx.x & 31;
  const int lig = lane & (L - 1);
  const int lane0 = lane - lig;
  const unsigned mask = L == 32 ? 0xffffffffu : ((1u << L) - 1u) << lane0;
  const long long row = static_cast<long long>(rb) * (kThreads / L) + threadIdx.x / L;
  if (row >= n) return;  // the whole group leaves: its mask names no other lane

  const int kend = min(KV, (slab + 1) * slabV);
  int kk[NG];
  V acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    kk[g] = slab * slabV + lig + g * L;
    acc[g] = vzero(W);
  }
  const size_t e = static_cast<size_t>(row) * r;
  gather_entries<V, NG>(W, KV, s, idx + e, vals + e, r, L, lig, lane0, mask, kk, kend, acc);
  if constexpr (SYM) {
    const int p0 = ptr[row];
    gather_entries<V, NG>(W, KV, s, src + p0, vt + p0, ptr[row + 1] - p0, L, lig, lane0, mask,
                          kk, kend, acc);
  }
  V* o = out + static_cast<size_t>(row) * KV;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (kk[g] < kend) o[kk[g]] = acc[g];
  }
}

template <typename V, bool SYM>
int launch(const float* vals, const int* idx, const int* ptr, const int* src, const float* vt,
           const void* W, int n, int r, int s, int K, int slab_cols, void* out,
           cudaStream_t st) {
  const int unit = static_cast<int>(sizeof(V) / sizeof(float));
  const int KV = K / unit;
  const V* Wv = static_cast<const V*>(W);
  V* ov = static_cast<V*>(out);
  const bool resident = static_cast<size_t>(s) * K * sizeof(float) <= kL2ResidentBytes;
  if (!SYM && slab_cols == 0 && resident) {
    const int rows_per_block = kThreads / 32;
    ell_row_kernel<V><<<(n + rows_per_block - 1) / rows_per_block, kThreads, 0, st>>>(
        vals, idx, Wv, n, r, s, KV, ov);
    return static_cast<int>(cudaGetLastError());
  }
  int slabV = KV;
  if (slab_cols > 0) {
    slabV = (slab_cols + unit - 1) / unit;
  } else if (!resident) {
    slabV = kSlabCols / unit;
  }
  slabV = std::min(std::min(slabV, KV), 32 * kMaxGroups);
  int L = 4;
  while (L < 32 && L < slabV) L *= 2;
  const int NG = (slabV + L - 1) / L;
  const int slabs = (KV + slabV - 1) / slabV;
  const int rows_per_block = kThreads / L;
  const long long row_blocks = (static_cast<long long>(n) + rows_per_block - 1) / rows_per_block;
  if (row_blocks * slabs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_blocks * slabs));
  switch (NG) {
#define FLGP_ELL_CASE(G)                                                                    \
  case G:                                                                                   \
    ell_gather_kernel<V, G, SYM><<<grid, kThreads, 0, st>>>(                                \
        vals, idx, ptr, src, vt, Wv, n, r, s, KV, slabV, L, static_cast<int>(row_blocks), ov); \
    break;
    FLGP_ELL_CASE(1) FLGP_ELL_CASE(2) FLGP_ELL_CASE(3) FLGP_ELL_CASE(4)
#undef FLGP_ELL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool SYM>
int dispatch(const void* vals, const void* idx, const void* ptr, const void* src, const void* vt,
             const void* W, int n, int r, int s, int K, int slab_cols, void* out, void* stream) {
  if (n <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  if (r < 0 || s <= 0 || slab_cols < 0 || out == W) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const auto f = (K % 4 == 0 && aligned) ? launch<float4, SYM> : launch<float, SYM>;
  return f(static_cast<const float*>(vals), static_cast<const int*>(idx),
           static_cast<const int*>(ptr), static_cast<const int*>(src),
           static_cast<const float*>(vt), W, n, r, s, K, slab_cols, out,
           static_cast<cudaStream_t>(stream));
}

}  // namespace

// vals, idx (n, r) f32/i32; W (s, K) f32 -> out (n, K) f32.  slab_cols = 0
// lets the entry point choose (the row kernel when W fits in the L2, else
// slabs of kSlabCols); the tests pass a width to force the slab kernel.
extern "C" int flgp_ell_matmat(const void* vals, const void* idx, const void* W, int n, int r,
                               int s, int K, int slab_cols, void* out, void* stream) {
  return dispatch<false>(vals, idx, nullptr, nullptr, nullptr, W, n, r, s, K, slab_cols, out,
                         stream);
}

// vals, idx (n, r); ptr (n + 1) i32, src, vt (ptr[n]) i32/f32: the transpose
// of the graph as CSR; X (n, K) f32 -> out (n, K) f32 = (Z + Z^T) X.
extern "C" int flgp_ell_sym_matmat(const void* vals, const void* idx, const void* ptr,
                                   const void* src, const void* vt, const void* X, int n, int r,
                                   int K, int slab_cols, void* out, void* stream) {
  return dispatch<true>(vals, idx, ptr, src, vt, X, n, r, n, K, slab_cols, out, stream);
}
