// Random-walk sampler over a CSR graph (node2vec, 1st and 2nd order).
//
// The port's copy of the JAX package's csrc/walker.cpp: the native replacement
// for the csrgraph/nodevectors numba walk generation of the reference
// (src/stonkgs/models/node2vec.py:291-334):
// `epochs` walks of length `walk_len` per node, p=q=1 -> uniform next-hop
// (the reference's production setting), general p/q via rejection sampling.
//
// Exposed with a plain C ABI for ctypes. Deterministic given `seed`:
// each walk's RNG stream is derived from (seed, walk_row), so results are
// independent of thread count.
//
// Built at first use by stonkgs_tpu_torch/data/walker.py:
//        g++ -O3 -shared -fPIC -std=c++17 -pthread
//        -o libwalker.so walker.cpp

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64: fast, high-quality 64-bit mixer for per-walk streams.
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  inline uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // uniform in [0, n)
  inline uint64_t below(uint64_t n) { return next() % n; }
  // uniform in [0, 1)
  inline double uniform() { return (next() >> 11) * 0x1.0p-53; }
};

inline bool has_edge(const int64_t* indptr, const int32_t* indices,
                     int32_t u, int32_t v) {
  // binary search in the (sorted) adjacency of u
  int64_t lo = indptr[u], hi = indptr[u + 1];
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (indices[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < indptr[u + 1] && indices[lo] == v;
}

void walk_range(const int64_t* indptr, const int32_t* indices,
                int64_t n_nodes, int32_t walk_len, int32_t epochs,
                uint64_t seed, double p, double q,
                int64_t row_begin, int64_t row_end, int32_t* out) {
  const bool first_order = (p == 1.0 && q == 1.0);
  const double inv_p = 1.0 / p;
  const double inv_q = 1.0 / q;
  double max_w = 1.0;
  if (inv_p > max_w) max_w = inv_p;
  if (inv_q > max_w) max_w = inv_q;

  for (int64_t row = row_begin; row < row_end; ++row) {
    Rng rng(seed * 0x9E3779B97F4A7C15ull + (uint64_t)row * 0xD1B54A32D192ED03ull + 1);
    int32_t cur = (int32_t)(row % n_nodes);  // epoch-major: row = e*n + node
    int32_t prev = -1;
    int32_t* w = out + row * walk_len;
    w[0] = cur;
    for (int32_t t = 1; t < walk_len; ++t) {
      int64_t deg = indptr[cur + 1] - indptr[cur];
      if (deg == 0) {  // dead end: stay put
        w[t] = cur;
        prev = cur;
        continue;
      }
      int32_t nxt;
      if (first_order || prev < 0) {
        nxt = indices[indptr[cur] + (int64_t)rng.below((uint64_t)deg)];
      } else {
        // 2nd-order via rejection sampling on the node2vec bias
        for (;;) {
          int32_t cand = indices[indptr[cur] + (int64_t)rng.below((uint64_t)deg)];
          double wgt;
          if (cand == prev) {
            wgt = inv_p;
          } else if (has_edge(indptr, indices, prev, cand)) {
            wgt = 1.0;
          } else {
            wgt = inv_q;
          }
          if (rng.uniform() * max_w <= wgt) {
            nxt = cand;
            break;
          }
        }
      }
      w[t] = nxt;
      prev = cur;
      cur = nxt;
    }
  }
}

}  // namespace

extern "C" {

// out must hold (epochs * n_nodes) * walk_len int32 values.
void random_walks(const int64_t* indptr, const int32_t* indices,
                  int64_t n_nodes, int32_t walk_len, int32_t epochs,
                  uint64_t seed, double p, double q, int32_t n_threads,
                  int32_t* out) {
  const int64_t total_rows = (int64_t)epochs * n_nodes;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > total_rows) n_threads = (int32_t)total_rows;
  std::vector<std::thread> threads;
  const int64_t chunk = (total_rows + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = (int64_t)t * chunk;
    int64_t hi = lo + chunk;
    if (hi > total_rows) hi = total_rows;
    if (lo >= hi) break;
    threads.emplace_back(walk_range, indptr, indices, n_nodes, walk_len,
                         epochs, seed, p, q, lo, hi, out);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
