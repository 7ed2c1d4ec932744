// Grid-hash k-nearest-neighbor mean squared distance.
//
// Native replacement for the reference's simple-knn CUDA extension
// (consumed at LoG/utils/file.py:88-91): for every point, the mean squared
// distance to its k nearest neighbors, used to initialize Gaussian scales.
// Uniform-grid spatial hash: O(N) bucket build + constant-radius ring search
// with progressive radius expansion; multithreaded over points.
//
// Exposed C ABI (ctypes): knn_mean_sq_dist(points, n, k, out).
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Grid {
  float mn[3];
  float cell;
  int dims[3];
  std::vector<int32_t> cell_start;  // size nc+1
  std::vector<int32_t> order;       // point ids sorted by cell

  inline int64_t cell_of(const float* p) const {
    int c[3];
    for (int d = 0; d < 3; ++d) {
      int v = (int)((p[d] - mn[d]) / cell);
      c[d] = std::min(std::max(v, 0), dims[d] - 1);
    }
    return ((int64_t)c[2] * dims[1] + c[1]) * dims[0] + c[0];
  }
};

void build_grid(const float* pts, int64_t n, int k, Grid& g) {
  float mx[3];
  for (int d = 0; d < 3; ++d) {
    g.mn[d] = pts[d];
    mx[d] = pts[d];
  }
  for (int64_t i = 1; i < n; ++i) {
    for (int d = 0; d < 3; ++d) {
      float v = pts[i * 3 + d];
      g.mn[d] = std::min(g.mn[d], v);
      mx[d] = std::max(mx[d], v);
    }
  }
  float ext[3], vol = 1.f;
  for (int d = 0; d < 3; ++d) {
    ext[d] = std::max(mx[d] - g.mn[d], 1e-9f);
    vol *= ext[d];
  }
  // target ~ (k+1) points per cell
  float target = std::cbrt(vol * (k + 1) / std::max<int64_t>(n, 1));
  g.cell = std::max(target, 1e-9f);
  int64_t nc = 1;
  for (int d = 0; d < 3; ++d) {
    g.dims[d] = std::max(1, std::min(1024, (int)(ext[d] / g.cell) + 1));
    nc *= g.dims[d];
  }
  std::vector<int32_t> counts(nc + 1, 0);
  std::vector<int64_t> cell_id(n);
  for (int64_t i = 0; i < n; ++i) {
    cell_id[i] = g.cell_of(pts + i * 3);
    counts[cell_id[i] + 1]++;
  }
  for (int64_t c = 0; c < nc; ++c) counts[c + 1] += counts[c];
  g.cell_start.assign(counts.begin(), counts.end());
  g.order.resize(n);
  std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t i = 0; i < n; ++i) g.order[cursor[cell_id[i]]++] = (int32_t)i;
}

void query_point(const float* pts, const Grid& g, int64_t i, int k,
                 float* out) {
  const float* p = pts + i * 3;
  int base[3];
  for (int d = 0; d < 3; ++d) {
    int v = (int)((p[d] - g.mn[d]) / g.cell);
    base[d] = std::min(std::max(v, 0), g.dims[d] - 1);
  }
  std::vector<float> best(k, 1e30f);  // squared distances, max-heap-ish
  auto push = [&](float d2) {
    if (d2 >= best[k - 1]) return;
    int j = k - 1;
    while (j > 0 && best[j - 1] > d2) {
      best[j] = best[j - 1];
      --j;
    }
    best[j] = d2;
  };
  int max_ring = std::max(std::max(g.dims[0], g.dims[1]), g.dims[2]);
  for (int ring = 0; ring <= max_ring; ++ring) {
    // cells whose Chebyshev distance from base == ring
    bool any_cell = false;
    for (int dz = -ring; dz <= ring; ++dz) {
      int z = base[2] + dz;
      if (z < 0 || z >= g.dims[2]) continue;
      for (int dy = -ring; dy <= ring; ++dy) {
        int y = base[1] + dy;
        if (y < 0 || y >= g.dims[1]) continue;
        bool edge_zy =
            (std::abs(dz) == ring) || (std::abs(dy) == ring);
        for (int dx = -ring; dx <= ring; ++dx) {
          if (!edge_zy && std::abs(dx) != ring) continue;
          int x = base[0] + dx;
          if (x < 0 || x >= g.dims[0]) continue;
          any_cell = true;
          int64_t c = ((int64_t)z * g.dims[1] + y) * g.dims[0] + x;
          for (int32_t s = g.cell_start[c]; s < g.cell_start[c + 1]; ++s) {
            int32_t j = g.order[s];
            if (j == (int32_t)i) continue;
            const float* q = pts + (int64_t)j * 3;
            float d2 = 0;
            for (int d = 0; d < 3; ++d) {
              float t = p[d] - q[d];
              d2 += t * t;
            }
            push(d2);
          }
        }
      }
    }
    // done when the k-th best is closer than the guaranteed-searched radius
    float safe = ring * g.cell;
    if (best[k - 1] < safe * safe) break;
    if (!any_cell && ring > 0) break;
  }
  float mean = 0;
  for (int j = 0; j < k; ++j) mean += (best[j] < 1e29f ? best[j] : 0.f);
  out[i] = mean / k;
}

}  // namespace

extern "C" {

void knn_mean_sq_dist(const float* pts, int64_t n, int k, float* out,
                      int n_threads) {
  if (n == 0) return;
  Grid g;
  build_grid(pts, n, k, g);
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    const int64_t B = 1024;
    while (true) {
      int64_t s = next.fetch_add(B);
      if (s >= n) break;
      int64_t e = std::min(s + B, n);
      for (int64_t i = s; i < e; ++i) query_point(pts, g, i, k, out);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
}
}
