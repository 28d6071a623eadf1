// Native KNN for Gaussian scale initialization (host C++).
//
// A copy of the JAX package's `native/simple_knn.cpp`, so that the port
// builds its own. It computes, for every point, the mean squared
// distance to its 3 nearest neighbors -- the quantity 3DGS uses to
// initialize log-scales from a point cloud (gaussian_model.py:288-292),
// which the reference computes with its CUDA simple-knn
// (gaussiansplatting/submodules/simple-knn/simple_knn.cu).
//
// Same algorithmic shape as the CUDA kernel, on a multicore CPU: global
// min/max reduce -> 30-bit Morton codes (simple_knn.cu:45-61) -> sort ->
// windowed candidate search over the Morton order with distance-bound
// early rejection (:147-183). The Morton window makes it approximate in
// the same way the reference's 1024-point boxed search is; the window
// here is +/-WINDOW sorted neighbors, refined with a best-3 heap.
//
// Built at first use by `native/__init__.py` (g++ -O3 -shared -fPIC)
// into the git-ignored build/native/ and bound with ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint32_t expand_bits(uint32_t v) {
  // spread 10 bits over 30 (simple_knn.cu prepMorton)
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

inline uint32_t morton3(float x, float y, float z) {
  uint32_t xi = (uint32_t)std::min(std::max(x * 1023.0f, 0.0f), 1023.0f);
  uint32_t yi = (uint32_t)std::min(std::max(y * 1023.0f, 0.0f), 1023.0f);
  uint32_t zi = (uint32_t)std::min(std::max(z * 1023.0f, 0.0f), 1023.0f);
  return (expand_bits(xi) << 2) | (expand_bits(yi) << 1) | expand_bits(zi);
}

struct Best3 {
  float d[3] = {1e30f, 1e30f, 1e30f};
  inline void insert(float v) {
    if (v < d[2]) {
      d[2] = v;
      if (d[2] < d[1]) std::swap(d[1], d[2]);
      if (d[1] < d[0]) std::swap(d[0], d[1]);
    }
  }
  inline float mean() const { return (d[0] + d[1] + d[2]) / 3.0f; }
  inline float worst() const { return d[2]; }
};

}  // namespace

extern "C" {

// pts: [n, 3] float32, out: [n] float32 mean squared 3-NN distance.
// window: half-width of the Morton-order candidate window (e.g. 64).
void mean_sq_dist_3nn(const float* pts, int64_t n, float* out,
                      int window, int n_threads) {
  if (n <= 1) {
    for (int64_t i = 0; i < n; ++i) out[i] = 0.0f;
    return;
  }
  if (n <= 4) {  // tiny: brute force
    for (int64_t i = 0; i < n; ++i) {
      Best3 b;
      for (int64_t j = 0; j < n; ++j) {
        if (i == j) continue;
        float dx = pts[3 * i] - pts[3 * j];
        float dy = pts[3 * i + 1] - pts[3 * j + 1];
        float dz = pts[3 * i + 2] - pts[3 * j + 2];
        b.insert(dx * dx + dy * dy + dz * dz);
      }
      float s = 0.0f;
      int c = 0;
      for (int k = 0; k < 3 && k < n - 1; ++k) {
        s += b.d[k];
        ++c;
      }
      out[i] = c ? s / c : 0.0f;
    }
    return;
  }

  float mn[3] = {1e30f, 1e30f, 1e30f};
  float mx[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], pts[3 * i + k]);
      mx[k] = std::max(mx[k], pts[3 * i + k]);
    }
  }
  float span[3];
  for (int k = 0; k < 3; ++k)
    span[k] = std::max(mx[k] - mn[k], 1e-12f);

  std::vector<std::pair<uint32_t, int64_t>> order(n);
  for (int64_t i = 0; i < n; ++i) {
    float x = (pts[3 * i] - mn[0]) / span[0];
    float y = (pts[3 * i + 1] - mn[1]) / span[1];
    float z = (pts[3 * i + 2] - mn[2]) / span[2];
    order[i] = {morton3(x, y, z), i};
  }
  std::sort(order.begin(), order.end());

  if (n_threads <= 0)
    n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  const int64_t chunk = (n + n_threads - 1) / n_threads;

  // Boxed AABB pass (simple_knn.cu boxMinMax/boxMeanDist, :97-183):
  // partition the Morton order into boxes, then refine each point's
  // best-3 against every box that can beat its current worst distance.
  const int64_t BOX = 256;
  const int64_t n_boxes = (n + BOX - 1) / BOX;
  std::vector<float> box_min(3 * n_boxes), box_max(3 * n_boxes);
  for (int64_t b = 0; b < n_boxes; ++b) {
    float bmn[3] = {1e30f, 1e30f, 1e30f};
    float bmx[3] = {-1e30f, -1e30f, -1e30f};
    const int64_t lo = b * BOX, hi = std::min(n, lo + BOX);
    for (int64_t t = lo; t < hi; ++t) {
      const int64_t j = order[t].second;
      for (int k = 0; k < 3; ++k) {
        bmn[k] = std::min(bmn[k], pts[3 * j + k]);
        bmx[k] = std::max(bmx[k], pts[3 * j + k]);
      }
    }
    for (int k = 0; k < 3; ++k) {
      box_min[3 * b + k] = bmn[k];
      box_max[3 * b + k] = bmx[k];
    }
  }

  auto box_dist2 = [&](int64_t b, float px, float py, float pz) {
    float d2 = 0.0f;
    const float p[3] = {px, py, pz};
    for (int k = 0; k < 3; ++k) {
      float lo = box_min[3 * b + k], hi = box_max[3 * b + k];
      float d = (p[k] < lo) ? lo - p[k] : (p[k] > hi ? p[k] - hi : 0.0f);
      d2 += d * d;
    }
    return d2;
  };

  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t s = lo; s < hi; ++s) {
      const int64_t i = order[s].second;
      const float px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
      Best3 best;
      auto scan_box = [&](int64_t b) {
        const int64_t blo = b * BOX, bhi = std::min(n, blo + BOX);
        for (int64_t t = blo; t < bhi; ++t) {
          if (t == s) continue;
          const int64_t j = order[t].second;
          const float dx = px - pts[3 * j];
          const float dy = py - pts[3 * j + 1];
          const float dz = pz - pts[3 * j + 2];
          best.insert(dx * dx + dy * dy + dz * dz);
        }
      };
      // seed the bound from the point's own (Morton-local) box, then
      // refine against every box the bound can't reject
      // (simple_knn.cu:147-183). Each candidate is visited exactly once.
      const int64_t b_own = s / BOX;
      scan_box(b_own);
      for (int64_t b = 0; b < n_boxes; ++b) {
        if (b == b_own) continue;
        if (box_dist2(b, px, py, pz) > best.worst()) continue;
        scan_box(b);
      }
      out[i] = best.mean();
    }
  };

  std::vector<std::thread> threads;
  for (int tix = 0; tix < n_threads; ++tix) {
    int64_t lo = tix * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& t : threads) t.join();
}

// k-nearest-neighbor squared distances of queries against points
// (reference knn.py role). Brute force, threaded over queries.
void knn_sq_dists(const float* pts, int64_t n, const float* queries,
                  int64_t q, int k, float* out, int n_threads) {
  if (n_threads <= 0)
    n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  const int64_t chunk = (q + n_threads - 1) / n_threads;
  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<float> best(k);
    for (int64_t iq = lo; iq < hi; ++iq) {
      for (int kk = 0; kk < k; ++kk) best[kk] = 1e30f;
      const float px = queries[3 * iq], py = queries[3 * iq + 1],
                  pz = queries[3 * iq + 2];
      for (int64_t j = 0; j < n; ++j) {
        const float dx = px - pts[3 * j];
        const float dy = py - pts[3 * j + 1];
        const float dz = pz - pts[3 * j + 2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best[k - 1]) {
          int pos = k - 1;
          while (pos > 0 && best[pos - 1] > d2) {
            best[pos] = best[pos - 1];
            --pos;
          }
          best[pos] = d2;
        }
      }
      std::memcpy(out + iq * k, best.data(), sizeof(float) * k);
    }
  };
  std::vector<std::thread> threads;
  for (int tix = 0; tix < n_threads; ++tix) {
    int64_t lo = tix * chunk;
    int64_t hi = std::min(q, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
