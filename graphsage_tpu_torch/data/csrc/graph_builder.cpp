// Native host-ingest kernels for graphsage_tpu.
//
// Replaces the reference's Python startup hot loops with C++:
//   * pad_adjacency  — dense padded adjacency construction
//                      (reference: graphsage/minibatch.py:227-259,
//                       an O(N * max_degree) Python loop)
//   * random_walks   — random-walk co-occurrence pair generation
//                      (reference: graphsage/utils.py:77-92)
//
// Exposed as a plain C ABI consumed via ctypes
// (graphsage_tpu/data/native.py). Parallelized over nodes with a simple
// thread pool; per-node RNG streams are derived with splitmix64 so results
// are deterministic for a given seed regardless of thread count.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// splitmix64: seeds per-node xoshiro-style streams deterministically.
static inline uint64_t splitmix64(uint64_t& x) {
  uint64_t z = (x += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {}
  inline uint64_t next() { return splitmix64(s); }
  // Unbiased bounded integer via rejection-free Lemire trick (bias is
  // negligible for our bounds << 2^64, so use the multiply-shift form).
  inline uint32_t below(uint32_t bound) {
    return static_cast<uint32_t>((next() * static_cast<__uint128_t>(bound)) >> 64);
  }
};

static void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = std::min<int64_t>(hw ? hw : 1, std::max<int64_t>(1, n / 1024));
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Build a padded dense adjacency matrix [ (n+1) * max_degree ].
// Row i: if deg==0 -> all n (dummy); if deg > max_degree -> sample without
// replacement; if deg < max_degree -> sample with replacement; else copy.
void pad_adjacency(const int32_t* pool, const int64_t* offsets, int64_t n,
                   int32_t max_degree, uint64_t seed, int32_t* out) {
  const int64_t md = max_degree;
  // Dummy row (index n) points at the dummy node itself.
  for (int64_t j = 0; j < md; ++j) out[n * md + j] = static_cast<int32_t>(n);

  parallel_for(n, [&](int64_t lo, int64_t hi) {
    std::vector<int32_t> scratch;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t beg = offsets[i], end = offsets[i + 1];
      const int64_t deg = end - beg;
      int32_t* row = out + i * md;
      if (deg == 0) {
        for (int64_t j = 0; j < md; ++j) row[j] = static_cast<int32_t>(n);
        continue;
      }
      uint64_t node_seed = seed ^ (0x9e3779b97f4a7c15ULL * (uint64_t)(i + 1));
      Rng rng(node_seed);
      if (deg == md) {
        std::memcpy(row, pool + beg, md * sizeof(int32_t));
      } else if (deg < md) {
        for (int64_t j = 0; j < md; ++j)
          row[j] = pool[beg + rng.below(static_cast<uint32_t>(deg))];
      } else {
        // Partial Fisher-Yates for sampling md of deg without replacement.
        scratch.assign(pool + beg, pool + end);
        for (int64_t j = 0; j < md; ++j) {
          int64_t k = j + rng.below(static_cast<uint32_t>(deg - j));
          std::swap(scratch[j], scratch[k]);
          row[j] = scratch[j];
        }
      }
    }
  });
}

// Random-walk co-occurrence pairs: num_walks walks of walk_len steps from
// each start node; emit (start, curr) whenever curr != start (pre-step),
// matching the reference emission rule (utils.py:83-89).
// Returns the number of pairs written (<= capacity).
int64_t random_walks(const int32_t* pool, const int64_t* offsets, int64_t n,
                     const int32_t* starts, int64_t num_starts,
                     int32_t num_walks, int32_t walk_len, uint64_t seed,
                     int32_t* out_pairs, int64_t capacity) {
  std::vector<int64_t> counts(num_starts, 0);
  const int64_t per_start_cap = (int64_t)num_walks * walk_len;

  parallel_for(num_starts, [&](int64_t lo, int64_t hi) {
    for (int64_t si = lo; si < hi; ++si) {
      const int32_t node = starts[si];
      const int64_t deg0 = offsets[node + 1] - offsets[node];
      if (deg0 == 0) continue;
      uint64_t s = seed ^ (0xbf58476d1ce4e5b9ULL * (uint64_t)(si + 1));
      Rng rng(s);
      int32_t* dst = out_pairs + 2 * si * per_start_cap;
      int64_t cnt = 0;
      for (int32_t w = 0; w < num_walks; ++w) {
        int32_t curr = node;
        for (int32_t st = 0; st < walk_len; ++st) {
          const int64_t beg = offsets[curr], deg = offsets[curr + 1] - beg;
          if (deg == 0) break;
          int32_t nxt = pool[beg + rng.below(static_cast<uint32_t>(deg))];
          if (curr != node) {
            dst[2 * cnt] = node;
            dst[2 * cnt + 1] = curr;
            ++cnt;
          }
          curr = nxt;
        }
      }
      counts[si] = cnt;
    }
  });

  // Compact the per-start blocks.
  int64_t total = 0;
  for (int64_t si = 0; si < num_starts; ++si) {
    const int32_t* src = out_pairs + 2 * si * per_start_cap;
    if (total + counts[si] > capacity) break;
    if (out_pairs + 2 * total != src) {
      std::memmove(out_pairs + 2 * total, src, 2 * counts[si] * sizeof(int32_t));
    }
    total += counts[si];
  }
  return total;
}

}  // extern "C"
