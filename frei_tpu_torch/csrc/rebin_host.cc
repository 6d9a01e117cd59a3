// Grouped trapezoid rebin — native host kernel.
//
// A copy of frei_tpu/native/rebin.cc, so that frei_tpu_torch builds its
// own host library.  C++ replacement for the reference's numba-JITed
// Trapz aggregation (frei/interp.py:156-202): for each (T, P) table row,
// accumulate trapezoid panels of adjacent high-resolution samples into
// their wavelength bin, counting a panel only when both samples share a
// bin (right-closed pd.cut-style bins), empty bins left at zero.
//
// Used by the ETL path (frei_tpu_torch/opacity/etl.py, engine="native")
// for host-only environments and for overlapping multi-GB opacity ingest
// with device compute.  Threaded over rows with std::thread; the inner
// loop is a single streaming pass (memory-bound).
//
// Build: see frei_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC
// into frei_tpu_torch/csrc/build/).

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Right-closed bin codes: x in (edges[k], edges[k+1]] -> k, else -1.
void bin_codes(const double* x, int64_t n, const double* edges,
               int64_t n_edges, int32_t* codes) {
  for (int64_t i = 0; i < n; ++i) {
    const double v = x[i];
    if (v <= edges[0] || v > edges[n_edges - 1]) {
      codes[i] = -1;
      continue;
    }
    // binary search: first edge >= v
    int64_t lo = 0, hi = n_edges - 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (edges[mid] >= v) hi = mid; else lo = mid + 1;
    }
    codes[i] = static_cast<int32_t>(lo - 1);
  }
}

// out[r*B + b] += sum of same-bin trapezoid panels of row r.
void grouped_trapz(const float* values, const double* x,
                   const int32_t* codes, float* out, int64_t R,
                   int64_t N, int64_t B, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<double> dx(N > 1 ? N - 1 : 0);
  for (int64_t i = 0; i + 1 < N; ++i) dx[i] = x[i + 1] - x[i];

  std::atomic<int64_t> next_row{0};
  auto worker = [&]() {
    std::vector<double> acc(B);
    for (;;) {
      const int64_t r = next_row.fetch_add(1);
      if (r >= R) break;
      const float* v = values + r * N;
      for (int64_t b = 0; b < B; ++b) acc[b] = 0.0;
      for (int64_t i = 0; i + 1 < N; ++i) {
        const int32_t c = codes[i];
        if (c >= 0 && c == codes[i + 1]) {
          acc[c] += 0.5 * (static_cast<double>(v[i]) +
                           static_cast<double>(v[i + 1])) * dx[i];
        }
      }
      float* o = out + r * B;
      for (int64_t b = 0; b < B; ++b) o[b] = static_cast<float>(acc[b]);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
