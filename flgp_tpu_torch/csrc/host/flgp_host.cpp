// FLGP host runtime of flgp_tpu_torch: a copy of flgp_tpu's native library,
// so that the PyTorch port imports nothing of the JAX package.
//
// The R package this project follows implements its graph-builder hot loops
// as C++ under RcppParallel/TBB (kNN: src/Utils.cpp:72-192, LAE:
// src/lae.cpp:15-153) and draws Polya-Gamma variates through a host
// callback (src/PGLogitModel.cpp:42-45).  The port's compute path is
// PyTorch and CUDA on the GPU; this library is the host runtime around it:
//
//   * a chunked, memory-mapped binary matrix loader (format FLGP0001) that
//     streams row chunks of datasets too large for host RAM into the
//     out-of-core fits,
//   * threaded host-side kNN + LAE for CPU pre-processing / oracle checks
//     (std::thread pool instead of TBB; same semantics, new implementation),
//   * a Devroye Polya-Gamma sampler used as a statistical oracle for the
//     on-device vectorized sampler.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (flgp_tpu_torch/native).
// C ABI only, consumed from Python via ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Thread pool: fixed workers, parallel_for over row ranges.
// ---------------------------------------------------------------------------

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(int n_threads) : stop_(false) {
    if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 2;
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }
  int size() const { return (int)workers_.size(); }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

// Block-parallel for over [0, n): each worker claims contiguous chunks.
void parallel_for(int64_t n, int n_threads,
                  const std::function<void(int64_t, int64_t)>& body) {
  if (n <= 0) return;
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 1 || n < 256) {
    body(0, n);
    return;
  }
  ThreadPool pool(n_threads);
  std::atomic<int> pending{0};
  std::mutex done_mu;
  std::condition_variable done_cv;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t lo = 0; lo < n; lo += chunk) {
    int64_t hi = std::min(lo + chunk, n);
    pending.fetch_add(1);
    pool.submit([&, lo, hi] {
      body(lo, hi);
      if (pending.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(done_mu);
        done_cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return pending.load() == 0; });
}

}  // namespace

// ---------------------------------------------------------------------------
// kNN: for each of n points, the r nearest of s anchors (squared Euclidean).
// Same batched |x|^2 - 2 x.u + |u|^2 expansion as the R package
// (src/Utils.cpp:102-145), threads over row blocks.
// ---------------------------------------------------------------------------

void flgp_knn(const float* X, int64_t n, int64_t d, const float* U, int64_t s,
              int64_t r, int32_t* idx_out, float* dist_out, int n_threads) {
  std::vector<float> u2(s);
  for (int64_t j = 0; j < s; ++j) {
    double acc = 0.0;
    const float* uj = U + j * d;
    for (int64_t k = 0; k < d; ++k) acc += (double)uj[k] * uj[k];
    u2[j] = (float)acc;
  }
  parallel_for(n, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<float, int32_t>> dist(s);
    for (int64_t i = lo; i < hi; ++i) {
      const float* xi = X + i * d;
      double x2 = 0.0;
      for (int64_t k = 0; k < d; ++k) x2 += (double)xi[k] * xi[k];
      for (int64_t j = 0; j < s; ++j) {
        const float* uj = U + j * d;
        double dot = 0.0;
        for (int64_t k = 0; k < d; ++k) dot += (double)xi[k] * uj[k];
        dist[j] = {(float)(x2 - 2.0 * dot + u2[j]), (int32_t)j};
      }
      std::partial_sort(dist.begin(), dist.begin() + r, dist.end());
      for (int64_t k = 0; k < r; ++k) {
        idx_out[i * r + k] = dist[k].second;
        dist_out[i * r + k] = std::max(dist[k].first, 0.0f);
      }
    }
  });
}

// ---------------------------------------------------------------------------
// LAE: per-point simplex-constrained least squares by FISTA with a
// Gershgorin step bound — the same fixed-iteration scheme as the port's
// ops/lae.py, so the two implementations cross-validate.
// R package semantics: src/lae.cpp:76-133.
// ---------------------------------------------------------------------------

namespace {

void project_simplex(double* v, double* scratch, int r) {
  // sort descending, cumulative-sum threshold
  std::memcpy(scratch, v, sizeof(double) * r);
  std::sort(scratch, scratch + r, std::greater<double>());
  double cssv = 0.0, theta = 0.0;
  int rho = 0;
  for (int k = 0; k < r; ++k) {
    cssv += scratch[k];
    double t = (cssv - 1.0) / (k + 1);
    if (scratch[k] - t > 0.0) {
      rho = k + 1;
      theta = t;
    }
  }
  if (rho == 0) theta = (cssv - 1.0) / r;
  for (int k = 0; k < r; ++k) v[k] = std::max(v[k] - theta, 0.0);
}

}  // namespace

void flgp_lae(const float* X, int64_t n, int64_t d, const float* U,
              const int32_t* knn_idx, int64_t r, int iters, float* w_out,
              int n_threads) {
  parallel_for(n, n_threads, [&](int64_t lo, int64_t hi) {
    std::vector<double> G(r * r), b(r), z_prev(r), z_curr(r), z_next(r), v(r),
        grad(r), scratch(r);
    for (int64_t i = lo; i < hi; ++i) {
      const float* xi = X + i * d;
      const int32_t* nbr = knn_idx + i * r;
      // Gram and rhs over the r anchors
      for (int64_t a = 0; a < r; ++a) {
        const float* ua = U + (int64_t)nbr[a] * d;
        double dot_b = 0.0;
        for (int64_t k = 0; k < d; ++k) dot_b += (double)xi[k] * ua[k];
        b[a] = dot_b;
        for (int64_t c = 0; c <= a; ++c) {
          const float* uc = U + (int64_t)nbr[c] * d;
          double g = 0.0;
          for (int64_t k = 0; k < d; ++k) g += (double)ua[k] * uc[k];
          G[a * r + c] = g;
          G[c * r + a] = g;
        }
      }
      double L = 1e-12;
      for (int64_t a = 0; a < r; ++a) {
        double row = 0.0;
        for (int64_t c = 0; c < r; ++c) row += std::fabs(G[a * r + c]);
        L = std::max(L, row);
      }
      double inv_L = 1.0 / L;
      std::fill(z_prev.begin(), z_prev.end(), 1.0 / r);
      std::fill(z_curr.begin(), z_curr.end(), 1.0 / r);
      double d_prev = 0.0, d_curr = 1.0;
      for (int it = 0; it < iters; ++it) {
        double alpha = (d_prev - 1.0) / d_curr;
        for (int64_t a = 0; a < r; ++a)
          v[a] = z_curr[a] + alpha * (z_curr[a] - z_prev[a]);
        for (int64_t a = 0; a < r; ++a) {
          double g = -b[a];
          for (int64_t c = 0; c < r; ++c) g += v[c] * G[c * r + a];
          grad[a] = g;
        }
        for (int64_t a = 0; a < r; ++a) z_next[a] = v[a] - inv_L * grad[a];
        project_simplex(z_next.data(), scratch.data(), (int)r);
        std::swap(z_prev, z_curr);
        std::swap(z_curr, z_next);
        double d_next = (1.0 + std::sqrt(1.0 + 4.0 * d_curr * d_curr)) / 2.0;
        d_prev = d_curr;
        d_curr = d_next;
      }
      for (int64_t a = 0; a < r; ++a) w_out[i * r + a] = (float)z_curr[a];
    }
  });
}

// ---------------------------------------------------------------------------
// Polya-Gamma PG(1, c) Devroye sampler (Polson-Scott-Windle 2013).
// Oracle for the on-device vectorized sampler (flgp_tpu/ops/polya_gamma.py);
// replaces the R package's pgdraw host callback
// (src/PGLogitModel.h:20-21).
// ---------------------------------------------------------------------------

namespace {

constexpr double kT = 0.64;
constexpr double kPi = 3.14159265358979323846;

double a_n(int n, double x) {
  double nh = n + 0.5;
  if (x <= kT)
    return kPi * nh * std::pow(2.0 / (kPi * x), 1.5) *
           std::exp(-2.0 * nh * nh / x);
  return kPi * nh * std::exp(-nh * nh * kPi * kPi * x / 2.0);
}

double norm_cdf(double x) { return 0.5 * std::erfc(-x / std::sqrt(2.0)); }

double sample_ig(std::mt19937_64& rng, double mu) {
  std::normal_distribution<double> N(0.0, 1.0);
  std::uniform_real_distribution<double> Uni(0.0, 1.0);
  double y = N(rng);
  y *= y;
  double x = mu + 0.5 * mu * mu * y -
             0.5 * mu * std::sqrt(4.0 * mu * y + mu * mu * y * y);
  if (Uni(rng) > mu / (mu + x)) x = mu * mu / std::max(x, 1e-300);
  return x;
}

double sample_rtigauss(std::mt19937_64& rng, double z) {
  std::uniform_real_distribution<double> Uni(0.0, 1.0);
  std::exponential_distribution<double> Exp(1.0);
  double mu = 1.0 / std::max(z, 1e-10);
  if (mu > kT) {
    for (;;) {
      double e1 = Exp(rng), e2 = Exp(rng);
      if (e1 * e1 > 2.0 * e2 / kT) continue;
      double x = kT / ((1.0 + kT * e1) * (1.0 + kT * e1));
      if (Uni(rng) <= std::exp(-0.5 * z * z * x)) return x;
    }
  }
  for (;;) {
    double x = sample_ig(rng, mu);
    if (x <= kT) return x;
  }
}

double sample_jstar(std::mt19937_64& rng, double z) {
  std::uniform_real_distribution<double> Uni(0.0, 1.0);
  std::exponential_distribution<double> Exp(1.0);
  double K = kPi * kPi / 8.0 + z * z / 2.0;
  double p = (kPi / (2.0 * K)) * std::exp(-K * kT);
  double sqrt_t = std::sqrt(kT);
  double q = 2.0 * std::exp(-z) *
             (norm_cdf((kT * z - 1.0) / sqrt_t) +
              std::exp(2.0 * z) * norm_cdf(-(kT * z + 1.0) / sqrt_t));
  for (;;) {
    double x;
    if (Uni(rng) < p / (p + q))
      x = kT + Exp(rng) / K;
    else
      x = sample_rtigauss(rng, z);
    double s = a_n(0, x);
    double y = Uni(rng) * s;
    int n = 0;
    for (;;) {
      ++n;
      double a = a_n(n, x);
      if (n % 2 == 1) {
        s -= a;
        if (y <= s) return x;  // accept
      } else {
        s += a;
        if (y > s) break;  // reject, redraw proposal
      }
      if (n > 1024) return x;  // series converged; numerically accept
    }
  }
}

}  // namespace

// One PG(b_i, c_i) draw per element; integer counts b_i (pgdraw semantics).
void flgp_pg_draw(uint64_t seed, const int32_t* b, const double* c, int64_t n,
                  double* out, int n_threads) {
  parallel_for(n, n_threads, [&](int64_t lo, int64_t hi) {
    std::mt19937_64 rng(seed + 0x9E3779B97F4A7C15ULL * (uint64_t)(lo + 1));
    for (int64_t i = lo; i < hi; ++i) {
      double z = std::fabs(c[i]) / 2.0;
      double acc = 0.0;
      for (int32_t k = 0; k < b[i]; ++k) acc += sample_jstar(rng, z);
      out[i] = acc / 4.0;
    }
  });
}

// ---------------------------------------------------------------------------
// Chunked memory-mapped matrix loader.
//
// File format "FLGP0001": a 32-byte header (magic, dtype code, rows, cols)
// followed by row-major data.  The loader mmaps the file and serves
// contiguous row ranges — the host-side feed for the n-sharded spectral
// pipeline when the dataset exceeds host RAM.
// ---------------------------------------------------------------------------

namespace {

struct MappedMatrix {
  void* base = nullptr;
  size_t bytes = 0;
  int64_t rows = 0;
  int64_t cols = 0;
  int32_t dtype = 0;  // 0 = f32, 1 = f64, 2 = i32
  int fd = -1;
};

size_t dtype_size(int32_t code) {
  switch (code) {
    case 0: return 4;
    case 1: return 8;
    case 2: return 4;
    default: return 0;
  }
}

constexpr char kMagic[8] = {'F', 'L', 'G', 'P', '0', '0', '0', '1'};

}  // namespace

int64_t flgp_matrix_write(const char* path, const void* data, int64_t rows,
                          int64_t cols, int32_t dtype) {
  size_t esz = dtype_size(dtype);
  if (esz == 0) return -1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;
  char header[32] = {0};
  std::memcpy(header, kMagic, 8);
  std::memcpy(header + 8, &dtype, 4);
  std::memcpy(header + 16, &rows, 8);
  std::memcpy(header + 24, &cols, 8);
  if (std::fwrite(header, 1, 32, f) != 32) { std::fclose(f); return -3; }
  size_t total = (size_t)rows * cols * esz;
  if (total && std::fwrite(data, 1, total, f) != total) {
    std::fclose(f);
    return -3;
  }
  std::fclose(f);
  return 0;
}

void* flgp_matrix_open(const char* path, int64_t* rows, int64_t* cols,
                       int32_t* dtype) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 32) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const char* hdr = (const char*)base;
  if (std::memcmp(hdr, kMagic, 8) != 0) {
    munmap(base, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* m = new MappedMatrix;
  m->base = base;
  m->bytes = st.st_size;
  m->fd = fd;
  std::memcpy(&m->dtype, hdr + 8, 4);
  std::memcpy(&m->rows, hdr + 16, 8);
  std::memcpy(&m->cols, hdr + 24, 8);
  *rows = m->rows;
  *cols = m->cols;
  *dtype = m->dtype;
  return m;
}

// Copy rows [start, start+count) into out; returns rows copied (clamped).
int64_t flgp_matrix_read(void* handle, int64_t start, int64_t count,
                         void* out) {
  auto* m = (MappedMatrix*)handle;
  if (!m || start < 0 || start >= m->rows) return 0;
  int64_t take = std::min(count, m->rows - start);
  size_t esz = dtype_size(m->dtype);
  size_t row_bytes = (size_t)m->cols * esz;
  const char* src = (const char*)m->base + 32 + (size_t)start * row_bytes;
  std::memcpy(out, src, (size_t)take * row_bytes);
  return take;
}

// Hint the kernel to prefetch rows [start, start+count) (overlap IO/compute).
void flgp_matrix_prefetch(void* handle, int64_t start, int64_t count) {
  auto* m = (MappedMatrix*)handle;
  if (!m || start < 0 || start >= m->rows) return;
  int64_t take = std::min(count, m->rows - start);
  size_t esz = dtype_size(m->dtype);
  size_t row_bytes = (size_t)m->cols * esz;
  char* addr = (char*)m->base + 32 + (size_t)start * row_bytes;
  // madvise needs page alignment
  size_t page = (size_t)sysconf(_SC_PAGESIZE);
  uintptr_t a = (uintptr_t)addr & ~(page - 1);
  size_t len = (size_t)take * row_bytes + ((uintptr_t)addr - a);
  madvise((void*)a, len, MADV_WILLNEED);
}

void flgp_matrix_close(void* handle) {
  auto* m = (MappedMatrix*)handle;
  if (!m) return;
  if (m->base) munmap(m->base, m->bytes);
  if (m->fd >= 0) ::close(m->fd);
  delete m;
}

// Streaming kNN straight off the mapped file: processes row chunks without
// materializing X in RAM (the R package's batch loop at
// src/Utils.cpp:107-120, lifted to out-of-core).
int64_t flgp_knn_stream(void* handle, const float* U, int64_t s, int64_t r,
                        int64_t chunk_rows, int32_t* idx_out, float* dist_out,
                        int n_threads) {
  auto* m = (MappedMatrix*)handle;
  if (!m || m->dtype != 0) return -1;
  int64_t n = m->rows, d = m->cols;
  for (int64_t lo = 0; lo < n; lo += chunk_rows) {
    int64_t take = std::min(chunk_rows, n - lo);
    flgp_matrix_prefetch(handle, lo + take, chunk_rows);
    const float* X = (const float*)((const char*)m->base + 32) + lo * d;
    flgp_knn(X, take, d, U, s, r, idx_out + lo * r, dist_out + lo * r,
             n_threads);
  }
  return n;
}

int flgp_hardware_threads() { return (int)std::thread::hardware_concurrency(); }

}  // extern "C"
