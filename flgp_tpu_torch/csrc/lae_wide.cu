// K2's run-time-r body: every fan-in above the templated bodies' 16, up to
// what one block's shared memory holds (r = 240 at 150 steps).
//
// Replaces, with lae.cu's bodies, the TPU kernel
// flgp_tpu/ops/pallas_kernels.py:fused_lae_tiles, which takes any r.  The
// templated body keeps a point's Gram's upper triangle, r(r+1)/2 floats, in
// one thread's registers: at r = 24 that would be 300 registers, and every
// further r another instance to compile.  Here one warp takes one point, and
// lane j owns entries j, j + 32, ... of every r-wide vector (b, z, z_prev,
// the step): NS slots a lane, NS = 1, 2, 4 or 8 (r <= 32, 64, 128, 256), the
// one template parameter, so registers follow r and four instances cover
// every r.
//
// What bounds it: issued instructions, as the templated body.  A step is
// O(r^2) float operations a point, but a sum over a (the gradient, the
// running sums) is one lane's sequential chain of r roundings, so the design
// keeps the instructions of those chains few:
//   * G: at NS = 1 lane j keeps G's column j, r floats, in registers; above
//     that the r x r floats live in the warp's slice of dynamic shared
//     memory, lane j reading column j of row a, conflict-free.  The one limit
//     of K2 is this slice: r^2 floats beside the momentum table in 227 KB
//     (r = 240 at 150 steps); the wrapper raises above.
//   * broadcasts: a vector every lane needs whole (v for the gradient, the
//     sorted values for the running sums) goes once into the warp's
//     16-byte-aligned slice `vec` and is read back 16 bytes at a time, four
//     values a load, instead of a shuffle a value.
//   * the sort starts from the last step's sorted order (each position
//     carries the entry it holds, `perm`, and takes that entry's new value):
//     FISTA moves the iterate a little a step, so the odd-even transposition
//     phases that follow find the order nearly sorted and stop after two
//     phases in a row that move nothing, a handful instead of r.
//
// The plain version's bits, as the templated body keeps them:
//   * every product and sum rounded on its own (__fmul_rn/__fadd_rn), in the
//     order of ops/lae.py:lae_weights_plain: G and b over the d coordinates,
//     the gradient over a, a Gershgorin row over its columns (G is symmetric
//     bit for bit: the same products in the same order), the running sums
//     left to right;
//   * z starts at the IEEE quotient 1/r (the plain version's 1.0/r rounded
//     to float32 is the same float for every r this body takes);
//   * the descending sort is an odd-even transposition across lanes with
//     fmaxf/fminf, as the templated body sorts in registers.  Whatever order
//     it starts from and whenever it stops, it ends sorted, and the sorted
//     values are one sequence (only equal values, or zeros of either sign,
//     can trade places, and no later step can tell them apart);
//   * the quotients (css_k - 1)/(k + 1) are IEEE divisions (__fdiv_rn, the
//     plain version's `/`), rho counts u_k - q_k > 0 over every k, and theta
//     is the quotient at rho - 1;
//   * the momentum comes from the same host table (fista_momentum).

#include "lae.cuh"

namespace flgp_k2 {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWideWarps = 8;     // points (warps) a block, at most

__host__ __device__ constexpr size_t pad4(size_t x) { return (x + 3) / 4 * 4; }

// floats of a warp's slice: `vec`, then at NS > 1 the r x r Gram
template <int NS>
__host__ __device__ constexpr size_t slice_floats(int r) {
  return pad4(static_cast<size_t>(NS) * 32 + (NS > 1 ? static_cast<size_t>(r) * r : 0));
}

// f(a, vec[a]) for a = 0 .. r-1 in order, vec read 16 bytes at a time.  N > 0:
// r <= N, fully unrolled (so that a is a constant in f); N = 0: a loop.
template <int N, class F>
__device__ __forceinline__ void each_of(const float* vec, int r, F&& f) {
  const float4* v4 = reinterpret_cast<const float4*>(vec);
  const auto four = [&](int q) {
    const float4 t = v4[q];
    f(4 * q, t.x);
    if (4 * q + 1 < r) f(4 * q + 1, t.y);
    if (4 * q + 2 < r) f(4 * q + 2, t.z);
    if (4 * q + 3 < r) f(4 * q + 3, t.w);
  };
  if constexpr (N > 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      if (4 * q >= r) break;
      four(q);
    }
  } else {
    for (int q = 0; 4 * q < r; ++q) four(q);
  }
}

// The warp's values x (lane j holds entries j, j + 32, ...) into vec,
// readable by every lane on return.
template <int NS>
__device__ __forceinline__ void publish(float* vec, const float (&x)[NS], int lane) {
  __syncwarp();   // every lane is done reading the last vector
#pragma unroll
  for (int m = 0; m < NS; ++m) vec[m * 32 + lane] = x[m];
  __syncwarp();
}

// The arguments as lae_kernel's (lae.cuh), r at run time; a warp a point,
// blockDim.x / 32 points a block.  Dynamic shared memory: the momentum table
// (iters floats, padded to 16 bytes), then each warp's slice.
template <int NS>
__global__ void __launch_bounds__(kWideWarps * 32)
lae_wide_kernel(const float* __restrict__ X, long long xs_p, long long xs_k,
                const float* __restrict__ U, const int* __restrict__ idx, long long n,
                long long npts, int c, int s, int d, int r, int iters,
                const float* __restrict__ alpha_tab, float* __restrict__ out) {
  extern __shared__ __align__(16) float wide_smem[];
  float* alpha_s = wide_smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* vec = wide_smem + pad4(iters) + static_cast<size_t>(warp) * slice_floats<NS>(r);
  float* Gs = vec + NS * 32;   // NS > 1
  for (int i = threadIdx.x; i < iters; i += blockDim.x) alpha_s[i] = alpha_tab[i];
  __syncthreads();

  const long long p = static_cast<long long>(blockIdx.x) * warps + warp;
  if (p >= npts) return;
  const size_t base = static_cast<size_t>(p / c) * r * c + static_cast<size_t>(p % c);
  if (p >= n) {  // a pad point of the last chunk
    for (int j = lane; j < r; j += 32) out[base + static_cast<size_t>(j) * c] = 0.0f;
    return;
  }
  const int slots = (r + 31) >> 5;

  int ia[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    const int j = m * 32 + lane;
    ia[m] = 0;
    if (j < r) {
      const int jj = idx[base + static_cast<size_t>(j) * c];
      ia[m] = (jj >= 0 && jj < s) ? jj : 0;  // indices come from knn; guard the gather
    }
  }

  // G[a][j] and b[j] summed over the d coordinates in order
  float gcol[NS == 1 ? 32 : 1];
  float b[NS];
  const float* x = X + p * xs_p;
  for (int k = 0; k < d; ++k) {
    const float xk = x[k * xs_k];
    float u[NS];
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      u[m] = m * 32 + lane < r ? U[static_cast<size_t>(ia[m]) * d + k] : 0.0f;
      const float pb = __fmul_rn(xk, u[m]);
      b[m] = (k == 0) ? pb : __fadd_rn(b[m], pb);
    }
    publish<NS>(vec, u, lane);
    if constexpr (NS == 1) {
      each_of<32>(vec, r, [&](int a, float ua) {
        const float pg = __fmul_rn(ua, u[0]);
        gcol[a] = (k == 0) ? pg : __fadd_rn(gcol[a], pg);
      });
    } else {
      each_of<0>(vec, r, [&](int a, float ua) {
        float* Grow = Gs + static_cast<size_t>(a) * r;
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          const int j = m * 32 + lane;
          if (m < slots && j < r) {
            const float pg = __fmul_rn(ua, u[m]);
            Grow[j] = (k == 0) ? pg : __fadd_rn(Grow[j], pg);
          }
        }
      });
    }
  }
  __syncwarp();

  // Gershgorin bound on lambda_max(G) -> fixed step 1/L; row j's sum is
  // column j's (G is symmetric bit for bit)
  float L = 0.0f;
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    const int j = m * 32 + lane;
    if (m < slots && j < r) {
      float rowsum;
      if constexpr (NS == 1) {
        rowsum = fabsf(gcol[0]);
#pragma unroll
        for (int e = 1; e < 32; ++e) {
          if (e >= r) break;
          rowsum = __fadd_rn(rowsum, fabsf(gcol[e]));
        }
      } else {
        rowsum = fabsf(Gs[j]);
        for (int e = 1; e < r; ++e)
          rowsum = __fadd_rn(rowsum, fabsf(Gs[static_cast<size_t>(e) * r + j]));
      }
      L = fmaxf(L, rowsum);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) L = fmaxf(L, __shfl_xor_sync(kFull, L, off));
  const float inv_L = 1.0f / (L + 1e-12f);

  const float z0 = __fdiv_rn(1.0f, static_cast<float>(r));
  float z[NS], z_prev[NS];
  int perm[NS];   // the entry at sorted position m*32 + lane in the last step
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    z[m] = z0;
    z_prev[m] = z0;
    perm[m] = m * 32 + lane < r ? m * 32 + lane : 0;
  }
  for (int it = 0; it < iters; ++it) {
    const float alpha = alpha_s[it];
    float v[NS], g[NS], w[NS];
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      v[m] = __fadd_rn(z[m], __fmul_rn(alpha, __fadd_rn(z[m], -z_prev[m])));
      g[m] = 0.0f;
    }
    // g_j = sum_a v_a G[a][j], a in order
    publish<NS>(vec, v, lane);
    if constexpr (NS == 1) {
      each_of<32>(vec, r, [&](int a, float va) {
        const float pg = __fmul_rn(va, gcol[a]);
        g[0] = (a == 0) ? pg : __fadd_rn(g[0], pg);
      });
    } else {
      each_of<0>(vec, r, [&](int a, float va) {
        const float* Grow = Gs + static_cast<size_t>(a) * r;
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          const int j = m * 32 + lane;
          if (m < slots && j < r) {
            const float pg = __fmul_rn(va, Grow[j]);
            g[m] = (a == 0) ? pg : __fadd_rn(g[m], pg);
          }
        }
      });
    }
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      w[m] = __fadd_rn(v[m], -__fmul_rn(inv_L, __fadd_rn(g[m], -b[m])));
      z_prev[m] = z[m];
    }

    // Project w onto the simplex.  u: the values in the last step's sorted
    // order, sorted descending by odd-even transposition from there.
    publish<NS>(vec, w, lane);
    float u[NS];
#pragma unroll
    for (int m = 0; m < NS; ++m) u[m] = vec[perm[m]];
    int still = 0;
    for (int ph = 0; ph < r && still < 2; ++ph) {
      float nxt[NS], prv[NS];
      int nxp[NS], prp[NS];
      if constexpr (NS == 1) {
        nxt[0] = prv[0] = __shfl_sync(kFull, u[0], ((lane & 1) == (ph & 1) ? lane + 1 : lane - 1) & 31);
        nxp[0] = prp[0] = __shfl_sync(kFull, perm[0], ((lane & 1) == (ph & 1) ? lane + 1 : lane - 1) & 31);
      } else {
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          if (m >= slots) break;
          nxt[m] = __shfl_down_sync(kFull, u[m], 1);
          prv[m] = __shfl_up_sync(kFull, u[m], 1);
          nxp[m] = __shfl_down_sync(kFull, perm[m], 1);
          prp[m] = __shfl_up_sync(kFull, perm[m], 1);
        }
#pragma unroll
        for (int m = 0; m < NS; ++m) {
          if (m >= slots) break;
          if (m + 1 < NS && m + 1 < slots) {
            const float first = __shfl_sync(kFull, u[m + 1], 0);
            const int first_p = __shfl_sync(kFull, perm[m + 1], 0);
            if (lane == 31) {
              nxt[m] = first;
              nxp[m] = first_p;
            }
          }
          if (m > 0) {
            const float last = __shfl_sync(kFull, u[m - 1], 31);
            const int last_p = __shfl_sync(kFull, perm[m - 1], 31);
            if (lane == 0) {
              prv[m] = last;
              prp[m] = last_p;
            }
          }
        }
      }
      bool moved = false;
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        const int i = m * 32 + lane;
        if (m < slots && i < r) {
          float now = u[m];
          if ((i & 1) == (ph & 1)) {
            if (i + 1 < r) {
              now = fmaxf(u[m], nxt[m]);
              if (nxt[m] > u[m]) perm[m] = nxp[m];
            }
          } else if (i >= 1) {
            now = fminf(prv[m], u[m]);
            if (prv[m] < u[m]) perm[m] = prp[m];
          }
          moved |= __float_as_uint(now) != __float_as_uint(u[m]);
          u[m] = now;
        }
      }
      still = __any_sync(kFull, moved) ? 0 : still + 1;
    }

    // running sums of the sorted values, left to right, one rounding a step:
    // lane j's css at position m*32 + j
    publish<NS>(vec, u, lane);
    float css[NS];
    if constexpr (NS == 1) {
      float run = 0.0f;
      each_of<32>(vec, r, [&](int a, float ua) {
        if (a == 0) run = ua;
        else if (a <= lane) run = __fadd_rn(run, ua);
      });
      css[0] = run;
    } else {
      float total = 0.0f;   // the sum through position m*32 - 1
#pragma unroll
      for (int m = 0; m < NS; ++m) {
        if (m >= slots) break;
        const int len = min(32, r - m * 32);
        float run = total;
        for (int t = 0; t < len; ++t) {
          const float ut = vec[m * 32 + t];
          const float next = (m == 0 && t == 0) ? ut : __fadd_rn(total, ut);
          if (t <= lane) run = next;
          total = next;
        }
        css[m] = run;
      }
    }

    // rho = max(1, #{k : u_k - (css_k - 1)/(k + 1) > 0}); theta = that quotient at rho - 1
    float q[NS];
    int count = 0;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      q[m] = 0.0f;
      if (m >= slots) break;
      const int i = m * 32 + lane;
      bool above = false;
      if (i < r) {
        q[m] = __fdiv_rn(__fadd_rn(css[m], -1.0f), static_cast<float>(i + 1));
        above = __fadd_rn(u[m], -q[m]) > 0.0f;
      }
      count += __popc(__ballot_sync(kFull, above));
    }
    const int kk = max(count, 1) - 1;
    float theta = 0.0f;
#pragma unroll
    for (int m = 0; m < NS; ++m) {
      if (m >= slots) break;
      const float qk = __shfl_sync(kFull, q[m], kk & 31);
      if (m == (kk >> 5)) theta = qk;
    }
#pragma unroll
    for (int m = 0; m < NS; ++m) z[m] = fmaxf(__fadd_rn(w[m], -theta), 0.0f);
  }

#pragma unroll
  for (int m = 0; m < NS; ++m) {
    const int j = m * 32 + lane;
    if (j < r) out[base + static_cast<size_t>(j) * c] = z[m];
  }
}

template <int NS>
int launch_wide_ns(const Args& a) {
  const size_t slice = slice_floats<NS>(a.r);
  const size_t table = pad4(static_cast<size_t>(a.iters));
  if ((table + slice) * sizeof(float) > kMaxBlockSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t warps = (kMaxBlockSmem / sizeof(float) - table) / slice;
  if (warps > kWideWarps) warps = kWideWarps;
  const size_t smem = (table + warps * slice) * sizeof(float);
  const auto kernel = lae_wide_kernel<NS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (a.npts + static_cast<long long>(warps) - 1) / static_cast<long long>(warps);
  kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(warps * 32), smem, a.stream>>>(
      a.X, a.xs_p, a.xs_k, a.U, a.idx, a.n, a.npts, a.c, a.s, a.d, a.r, a.iters, a.alpha, a.out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int launch_wide(const Args& a) {
  if (a.r < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (a.r <= 32) return launch_wide_ns<1>(a);
  if (a.r <= 64) return launch_wide_ns<2>(a);
  if (a.r <= 128) return launch_wide_ns<4>(a);
  if (a.r <= 256) return launch_wide_ns<8>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace flgp_k2
