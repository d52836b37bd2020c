// K9: raw ELL product out = Z @ W,  out[i, :] = sum_k vals[i, k] * W[idx[i, k], :].
//
// Replaces the TPU kernel ell_matmat (_ell_matmat_kernel) in
// flgp_tpu/ops/pallas_kernels.py.  Callers: the forward half of the sparse
// GLGP operator that LOBPCG applies once per iteration (s = n, W the (n, 3K)
// iterate block) and EllMatrix.matmat in spectrum_from_Z.
//
// What bounds it on the H100: memory.  Per row it reads 8r bytes of graph,
// gathers r rows of W (4K bytes each) and writes 4K bytes; there are 2rK
// flops per row against (r + 1) * 4K bytes, far below the f32 roofline
// ridge.  For s * K beyond the 50 MB L2 (the operator at n = 1e5, K = 384:
// 154 MB) the gathers go to HBM, and how many are reused depends on how far
// apart a point's neighbours are stored.
//
// Design: the TPU version keeps W whole in VMEM and recasts the gather as r
// one-hot (block, s) x (s, K) matmuls, which caps s.  Hopper gathers
// natively, so: one warp per row, lanes stride the K columns (16 bytes a
// lane when K is a multiple of 4 and the buffers are 16-byte aligned, else
// 4), so a warp's reads of one W row are contiguous; an fmaf chain over
// k = 0..r-1 in order; size_t offsets; no atomics, so the result is
// deterministic.  r, s and K are runtime values: there is no per-row state
// beyond the accumulator.  An index outside [0, s) contributes nothing; zero
// weights are not dropped (this is the raw product).  out must not alias W.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void ell_matmat_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                                  const float* __restrict__ W, int n, int r, int s, int K,
                                  float* __restrict__ out) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* v = vals + static_cast<size_t>(row) * r;
  const int* c = idx + static_cast<size_t>(row) * r;
  float* o = out + static_cast<size_t>(row) * K;
  for (int k = lane; k < K; k += 32) {
    float acc = 0.0f;
#pragma unroll 4
    for (int a = 0; a < r; ++a) {
      const int col = c[a];
      if (col >= 0 && col < s) acc = fmaf(v[a], W[static_cast<size_t>(col) * K + k], acc);
    }
    o[k] = acc;
  }
}

// K % 4 == 0 and W, out 16-byte aligned: a lane owns 4 consecutive columns.
__global__ void ell_matmat_vec4_kernel(const float* __restrict__ vals,
                                       const int* __restrict__ idx,
                                       const float4* __restrict__ W, int n, int r, int s, int K4,
                                       float4* __restrict__ out) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const float* v = vals + static_cast<size_t>(row) * r;
  const int* c = idx + static_cast<size_t>(row) * r;
  float4* o = out + static_cast<size_t>(row) * K4;
  for (int k = lane; k < K4; k += 32) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int a = 0; a < r; ++a) {
      const int col = c[a];
      if (col >= 0 && col < s) {
        const float w = v[a];
        const float4 x = W[static_cast<size_t>(col) * K4 + k];
        acc.x = fmaf(w, x.x, acc.x);
        acc.y = fmaf(w, x.y, acc.y);
        acc.z = fmaf(w, x.z, acc.z);
        acc.w = fmaf(w, x.w, acc.w);
      }
    }
    o[k] = acc;
  }
}

}  // namespace

// vals, idx (n, r) f32/i32; W (s, K) f32 -> out (n, K) f32.
extern "C" int flgp_ell_matmat(const void* vals, const void* idx, const void* W, int n, int r,
                               int s, int K, void* out, void* stream) {
  if (n <= 0 || K <= 0) return static_cast<int>(cudaSuccess);
  if (r < 0 || out == W) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = kThreads / 32;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (K % 4 == 0 && aligned) {
    ell_matmat_vec4_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int*>(idx),
        static_cast<const float4*>(W), n, r, s, K / 4, static_cast<float4*>(out));
  } else {
    ell_matmat_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int*>(idx),
        static_cast<const float*>(W), n, r, s, K, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
