// Native host-side runtime for colmap_tpu.
//
// Re-implements the reference's C++ host infrastructure where it is a real
// host-side hot path at scale (reference: src/colmap/util/threading.h:97-319
// ThreadPool/JobQueue; scene/correspondence_graph.cc CSR compaction;
// feature/sift.cc:1003 FindBestMatchesBruteForce):
//
//   - ct_union_find:      path-halving union-find for track building /
//                          fused-point dedup (connected components over
//                          (image,feature) observation edges)
//   - ct_build_csr:       counting-sort CSR grouping (correspondence graph
//                          finalization)
//   - ct_match_descriptors_u8: multi-threaded uint8 descriptor matching
//                          with ratio + distance + cross-check tests — the
//                          host-side matcher (the device path is the
//                          fused kernel in features/pallas_matcher.py)
//   - ct_hamming_dist:    popcount Hamming distances for the retrieval
//                          inverted files
//
// Built with: g++ -O3 -std=c++17 -shared -fPIC (no external deps).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Union-find
// ---------------------------------------------------------------------------

void ct_union_find(const int64_t* a, const int64_t* b, int64_t n_edges,
                   int64_t n_nodes, int64_t* labels) {
  std::vector<int64_t> parent(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ra = find(a[e]);
    int64_t rb = find(b[e]);
    if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
  }
  for (int64_t i = 0; i < n_nodes; ++i) labels[i] = find(i);
}

// ---------------------------------------------------------------------------
// CSR grouping (counting sort by key)
// ---------------------------------------------------------------------------

void ct_build_csr(const int64_t* keys, int64_t n, int64_t n_bins,
                  int64_t* offsets, int64_t* order) {
  std::memset(offsets, 0, sizeof(int64_t) * (n_bins + 1));
  for (int64_t i = 0; i < n; ++i) ++offsets[keys[i] + 1];
  for (int64_t b = 0; b < n_bins; ++b) offsets[b + 1] += offsets[b];
  std::vector<int64_t> cursor(offsets, offsets + n_bins);
  for (int64_t i = 0; i < n; ++i) order[cursor[keys[i]]++] = i;
}

// ---------------------------------------------------------------------------
// ThreadPool (reference: util/threading.h:193) — internal
// ---------------------------------------------------------------------------

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(int num_threads) : stop_(false) {
    if (num_threads <= 0)
      num_threads = std::max(1u, std::thread::hardware_concurrency());
    for (int i = 0; i < num_threads; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !jobs_.empty(); });
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
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }
  void Submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

void ParallelFor(int64_t n, int num_threads,
                 const std::function<void(int64_t, int64_t)>& body) {
  if (num_threads <= 0)
    num_threads = std::max(1u, std::thread::hardware_concurrency());
  num_threads = static_cast<int>(
      std::min<int64_t>(num_threads, std::max<int64_t>(n, 1)));
  std::vector<std::thread> threads;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi] { body(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

// ---------------------------------------------------------------------------
// uint8 SIFT descriptor matching (reference: FindBestMatchesBruteForce,
// feature/sift.cc:1003): distance = arccos(dot / 512^2), ratio 0.8 test,
// max distance 0.7, cross-check.
// ---------------------------------------------------------------------------

void ct_match_descriptors_u8(const uint8_t* d1, int32_t n1, const uint8_t* d2,
                             int32_t n2, float max_ratio, float max_distance,
                             int32_t cross_check, int32_t num_threads,
                             int32_t* out_idx) {
  if (n1 <= 0 || n2 <= 0) return;
  std::vector<float> inv_norm1(n1), inv_norm2(n2);
  auto norms = [](const uint8_t* d, int32_t n, std::vector<float>& out) {
    for (int32_t i = 0; i < n; ++i) {
      int64_t s = 0;
      const uint8_t* row = d + i * 128;
      for (int k = 0; k < 128; ++k) s += int64_t(row[k]) * row[k];
      out[i] = s > 0 ? 1.0f / std::sqrt(float(s)) : 0.0f;
    }
  };
  norms(d1, n1, inv_norm1);
  norms(d2, n2, inv_norm2);

  std::vector<int32_t> best12(n1, -1);
  std::vector<float> bestsim(n1);
  std::vector<int32_t> best21(cross_check ? n2 : 0, -1);
  std::vector<float> bestsim21(cross_check ? n2 : 0, -2.0f);
  std::vector<std::mutex> col_mu(cross_check ? 64 : 1);

  ParallelFor(n1, num_threads, [&](int64_t lo, int64_t hi) {
    std::vector<float> local21;
    std::vector<int32_t> local21_idx;
    if (cross_check) {
      local21.assign(n2, -2.0f);
      local21_idx.assign(n2, -1);
    }
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* r1 = d1 + i * 128;
      float s_best = -2.0f, s_second = -2.0f;
      int32_t j_best = -1;
      for (int32_t j = 0; j < n2; ++j) {
        const uint8_t* r2 = d2 + j * 128;
        int32_t dot = 0;
        for (int k = 0; k < 128; ++k) dot += int32_t(r1[k]) * r2[k];
        float sim = dot * inv_norm1[i] * inv_norm2[j];
        if (sim > s_best) {
          s_second = s_best;
          s_best = sim;
          j_best = j;
        } else if (sim > s_second) {
          s_second = sim;
        }
        if (cross_check && sim > local21[j]) {
          local21[j] = sim;
          local21_idx[j] = int32_t(i);
        }
      }
      float d_best = std::acos(std::min(std::max(s_best, -1.0f), 1.0f));
      float d_second = std::acos(std::min(std::max(s_second, -1.0f), 1.0f));
      if (j_best >= 0 && d_best <= max_distance &&
          d_best < max_ratio * d_second) {
        best12[i] = j_best;
        bestsim[i] = s_best;
      }
    }
    if (cross_check) {
      for (int32_t j = 0; j < n2; ++j) {
        if (local21_idx[j] < 0) continue;
        std::lock_guard<std::mutex> lock(col_mu[j & 63]);
        if (local21[j] > bestsim21[j]) {
          bestsim21[j] = local21[j];
          best21[j] = local21_idx[j];
        }
      }
    }
  });

  for (int32_t i = 0; i < n1; ++i) {
    int32_t j = best12[i];
    if (j >= 0 && cross_check && best21[j] != i) j = -1;
    out_idx[i] = j;
  }
}

// ---------------------------------------------------------------------------
// Hamming distances (retrieval inverted files)
// ---------------------------------------------------------------------------

void ct_hamming_dist(const uint64_t* sigs, int64_t n, uint64_t query,
                     int32_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = int32_t(__builtin_popcountll(sigs[i] ^ query));
}

}  // extern "C"
