// Native correctness oracle + timers for the tpujoin engine.
//
// The engine's equivalent of the reference's C++ support runtime
// (reference shared_stuff/shared.cpp): the reference verifies every GPU join
// by recomputing it with O(n*m) nested loops on the host and comparing both
// results as lexicographically-sorted multisets of (rowID_R, rowID_S) pairs
// (shared.cpp:129-171, sort+compare at :167-171, -1 on overflow at
// :158-160). This oracle keeps that exact contract and adds a sort-based
// O((n+m)log n + out) mode so the 100M-row benchmark configs are verifiable
// in practice (the quadratic mode is retained for small inputs as the
// independent ground truth).
//
// Exposed as a plain C ABI, bound from Python with ctypes (no pybind11 in
// the image). Build: make -C native   (g++ -O2 -shared -fPIC).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <utility>
#include <vector>

namespace {

using Pair = std::pair<int32_t, int32_t>;

// Recompute the equi-join with literal nested loops — the reference's
// oracle semantics (shared.cpp:154-165).
std::vector<Pair> join_nested(const int32_t* rk, int64_t n, const int32_t* sk,
                              int64_t m) {
  std::vector<Pair> out;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < m; ++j) {
      if (rk[i] == sk[j]) out.emplace_back((int32_t)i, (int32_t)j);
    }
  }
  return out;
}

// Sort-based recompute: independent fast path for large configs.
std::vector<Pair> join_sorted(const int32_t* rk, int64_t n, const int32_t* sk,
                              int64_t m) {
  std::vector<Pair> build(n);
  for (int64_t i = 0; i < n; ++i) build[i] = {rk[i], (int32_t)i};
  std::sort(build.begin(), build.end());
  std::vector<Pair> out;
  for (int64_t j = 0; j < m; ++j) {
    auto lo = std::lower_bound(build.begin(), build.end(),
                               Pair{sk[j], INT32_MIN});
    for (auto it = lo; it != build.end() && it->first == sk[j]; ++it) {
      out.emplace_back(it->second, (int32_t)j);
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Exact result size of R join S (for capacity planning and size checks).
int64_t oracle_join_count(const int32_t* rk, int64_t n, const int32_t* sk,
                          int64_t m, int use_nested) {
  auto pairs = use_nested ? join_nested(rk, n, sk, m) : join_sorted(rk, n, sk, m);
  return (int64_t)pairs.size();
}

// Multiset-equality check of an engine result against the recomputed join.
// Returns 1 = exact multiset match, 0 = mismatch, -1 = size mismatch
// (the reference's overflow signal, shared.cpp:158-160).
int oracle_check(const int32_t* rk, int64_t n, const int32_t* sk, int64_t m,
                 const int32_t* res_r, const int32_t* res_s, int64_t nres,
                 int use_nested) {
  auto expected = use_nested ? join_nested(rk, n, sk, m)
                             : join_sorted(rk, n, sk, m);
  if ((int64_t)expected.size() != nres) return -1;
  std::vector<Pair> got(nres);
  for (int64_t i = 0; i < nres; ++i) got[i] = {res_r[i], res_s[i]};
  // exact multiset equality via lexicographic sort of both pair vectors
  // (reference shared.cpp:167-171)
  std::sort(expected.begin(), expected.end());
  std::sort(got.begin(), got.end());
  return expected == got ? 1 : 0;
}

// Group-by-count oracle: returns number of distinct keys; fills
// (keys_out, counts_out) ascending if non-null and capacity suffices.
int64_t oracle_group_count(const int32_t* keys, int64_t n, int32_t* keys_out,
                           int32_t* counts_out, int64_t capacity) {
  std::vector<int32_t> sorted(keys, keys + n);
  std::sort(sorted.begin(), sorted.end());
  int64_t groups = 0;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i;
    while (j < n && sorted[j] == sorted[i]) ++j;
    if (keys_out && counts_out && groups < capacity) {
      keys_out[groups] = sorted[i];
      counts_out[groups] = (int32_t)(j - i);
    }
    ++groups;
    i = j;
  }
  return groups;
}

// Wall-clock timers with the reference's print contract
// ("For k, time taken: N microseconds", shared.cpp:10-31).
static std::chrono::high_resolution_clock::time_point g_t0;
static int g_timer_calls = 0;

void oracle_start_timer() { g_t0 = std::chrono::high_resolution_clock::now(); }

int64_t oracle_end_timer() {
  auto t1 = std::chrono::high_resolution_clock::now();
  auto us =
      std::chrono::duration_cast<std::chrono::microseconds>(t1 - g_t0).count();
  std::printf("For %d, time taken: %lld microseconds\n", g_timer_calls++,
              (long long)us);
  return (int64_t)us;
}

}  // extern "C"

extern "C" {

// RLE (factorized) join-result oracle: the engine may return the join as
// (probe_id, lo, cnt)[k] rows over a sorted-build-id array instead of
// materialized pairs (the factorized form a vectorized engine serves
// directly; reference parity is checked by expanding the same multiset).
// For each probe row, the claimed build-id run must equal (as a multiset)
// the true set of matching build rows. Returns 1 ok, 0 mismatch, -1 if
// claimed total size differs from the true join size.
int oracle_check_rle(const int32_t* rk, int64_t n, const int32_t* sk,
                     int64_t m, const int32_t* sorted_build_ids,
                     const int32_t* probe_ids, const int32_t* lo,
                     const int32_t* cnt, int64_t k) {
  std::vector<Pair> build(n);
  for (int64_t i = 0; i < n; ++i) build[i] = {rk[i], (int32_t)i};
  std::sort(build.begin(), build.end());

  // true total
  int64_t true_total = 0;
  for (int64_t j = 0; j < m; ++j) {
    auto range = std::equal_range(build.begin(), build.end(),
                                  Pair{sk[j], 0},
                                  [](const Pair& a, const Pair& b) {
                                    return a.first < b.first;
                                  });
    true_total += range.second - range.first;
  }
  int64_t claimed = 0;
  for (int64_t r = 0; r < k; ++r) claimed += cnt[r];
  if (claimed != true_total) return -1;

  std::vector<char> probe_seen(m, 0);
  // Runs sharing a key share one (lo, cnt) build slice, so the full
  // multiset comparison is paid once per DISTINCT (key, lo, cnt) and
  // repeat runs only check slice equality — total work O(sum of distinct
  // run lengths), not O(total pairs). Without this, skewed workloads
  // (Zipf at 10M rows ~ 4e11 pairs) make verification intractable even
  // though the factorized result itself is small.
  int32_t last_key = 0;
  int32_t last_lo = -1, last_cnt = -1;
  bool have_last = false;
  for (int64_t r = 0; r < k; ++r) {
    int32_t p = probe_ids[r];
    if (p < 0 || p >= m || probe_seen[p]) return 0;  // dup/invalid probe row
    probe_seen[p] = 1;
    if (have_last && sk[p] == last_key) {
      if (lo[r] != last_lo || cnt[r] != last_cnt) return 0;
      continue;
    }
    auto range = std::equal_range(build.begin(), build.end(),
                                  Pair{sk[p], 0},
                                  [](const Pair& a, const Pair& b) {
                                    return a.first < b.first;
                                  });
    int64_t want = range.second - range.first;
    if (cnt[r] != want) return 0;
    // claimed run ids must equal the true id multiset for this key
    std::vector<int32_t> got(sorted_build_ids + lo[r],
                             sorted_build_ids + lo[r] + cnt[r]);
    std::vector<int32_t> exp;
    exp.reserve(want);
    for (auto it = range.first; it != range.second; ++it)
      exp.push_back(it->second);
    std::sort(got.begin(), got.end());
    std::sort(exp.begin(), exp.end());
    if (got != exp) return 0;
    last_key = sk[p];
    last_lo = lo[r];
    last_cnt = cnt[r];
    have_last = true;
  }
  // probe rows not listed must have zero matches
  for (int64_t j = 0; j < m; ++j) {
    if (probe_seen[j]) continue;
    auto it = std::lower_bound(build.begin(), build.end(),
                               Pair{sk[j], INT32_MIN});
    if (it != build.end() && it->first == sk[j]) return 0;
  }
  return 1;
}

}  // extern "C"
