// Native binned-SAH BVH builder for raytrace_tpu.
//
// Host-side native runtime component: the reference likewise runs its
// acceleration-structure builds on the host CPU (OptiX Sbvh at
// cudarender.cpp:44-50 is host-built; the photon kd-tree is explicitly CPU,
// photonmappingrenderer.cpp:141-180). This builder emits the same flat
// pbrt-style layout as the numpy reference builder in ops/bvh.py (DFS
// pre-order, left child = node+1, explicit right-child index, leaves
// covering contiguous ranges of the permuted primitive array) so the JAX
// traversal consumes either interchangeably.
//
// Exposed to Python via ctypes (ops/bvh_native.py). Build: csrc/Makefile.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct AABB {
  float mn[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float mx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};

  void grow(const AABB& o) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], o.mn[k]);
      mx[k] = std::max(mx[k], o.mx[k]);
    }
  }
  void grow_point(const float* p) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], p[k]);
      mx[k] = std::max(mx[k], p[k]);
    }
  }
  float half_area() const {
    float dx = std::max(0.f, mx[0] - mn[0]);
    float dy = std::max(0.f, mx[1] - mn[1]);
    float dz = std::max(0.f, mx[2] - mn[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Task {
  int64_t lo, hi;
  int32_t depth;
  bool patch;
  int64_t node;
};

constexpr int kBins = 16;

}  // namespace

extern "C" int64_t build_bvh_sah(
    const float* v0, const float* v1, const float* v2, int64_t n,
    int32_t leaf_size,
    float* out_bmin, float* out_bmax,
    int32_t* out_right, int32_t* out_first, int32_t* out_count,
    int32_t* out_axis,
    int64_t* out_perm, int32_t* out_max_depth) {
  if (n <= 0) return 0;
  if (leaf_size < 1) leaf_size = 1;

  std::vector<AABB> pb(n);
  std::vector<float> cent(3 * n);
  for (int64_t i = 0; i < n; ++i) {
    const float* a = v0 + 3 * i;
    const float* b = v1 + 3 * i;
    const float* c = v2 + 3 * i;
    for (int k = 0; k < 3; ++k) {
      pb[i].mn[k] = std::min(a[k], std::min(b[k], c[k]));
      pb[i].mx[k] = std::max(a[k], std::max(b[k], c[k]));
      cent[3 * i + k] = 0.5f * (pb[i].mn[k] + pb[i].mx[k]);
    }
  }

  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);

  int64_t n_nodes = 0;
  int64_t perm_n = 0;
  int32_t max_depth = 0;

  std::vector<Task> stack;
  stack.reserve(128);
  stack.push_back({0, n, 1, false, -1});

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    if (t.patch) {
      out_right[t.node] = static_cast<int32_t>(n_nodes);
      continue;
    }
    const int64_t lo = t.lo, hi = t.hi, cnt = hi - lo;
    if (t.depth > max_depth) max_depth = t.depth;
    const int64_t node = n_nodes++;

    AABB nb, cb;
    for (int64_t i = lo; i < hi; ++i) {
      nb.grow(pb[idx[i]]);
      cb.grow_point(&cent[3 * idx[i]]);
    }
    for (int k = 0; k < 3; ++k) {
      out_bmin[3 * node + k] = nb.mn[k];
      out_bmax[3 * node + k] = nb.mx[k];
    }

    if (cnt <= leaf_size) {
      out_right[node] = 0;
      out_first[node] = static_cast<int32_t>(perm_n);
      out_count[node] = static_cast<int32_t>(cnt);
      out_axis[node] = 0;
      for (int64_t i = lo; i < hi; ++i) out_perm[perm_n++] = idx[i];
      continue;
    }

    int ax = 0;
    float best_ext = -1.f;
    for (int k = 0; k < 3; ++k) {
      float e = cb.mx[k] - cb.mn[k];
      if (e > best_ext) {
        best_ext = e;
        ax = k;
      }
    }

    int64_t mid = -1;
    if (best_ext > 1e-12f) {
      AABB bin_box[kBins];
      int64_t bin_cnt[kBins] = {0};
      const float scale = kBins / best_ext;
      const float c0 = cb.mn[ax];
      auto bin_of = [&](int64_t p) {
        int b = static_cast<int>((cent[3 * p + ax] - c0) * scale);
        return std::min(kBins - 1, std::max(0, b));
      };
      for (int64_t i = lo; i < hi; ++i) {
        int b = bin_of(idx[i]);
        bin_cnt[b]++;
        bin_box[b].grow(pb[idx[i]]);
      }
      // sweep: SAH cost for each of the kBins-1 split planes
      float left_area[kBins - 1];
      int64_t left_cnt[kBins - 1];
      {
        AABB acc;
        int64_t c = 0;
        for (int b = 0; b < kBins - 1; ++b) {
          acc.grow(bin_box[b]);
          c += bin_cnt[b];
          left_area[b] = acc.half_area();
          left_cnt[b] = c;
        }
      }
      float best_cost = FLT_MAX;
      int best_plane = -1;
      {
        AABB acc;
        int64_t c = 0;
        for (int b = kBins - 1; b >= 1; --b) {
          acc.grow(bin_box[b]);
          c += bin_cnt[b];
          if (left_cnt[b - 1] == 0 || c == 0) continue;
          float cost =
              left_area[b - 1] * left_cnt[b - 1] + acc.half_area() * c;
          if (cost < best_cost) {
            best_cost = cost;
            best_plane = b - 1;
          }
        }
      }
      if (best_plane >= 0) {
        auto* split = std::partition(
            idx.data() + lo, idx.data() + hi,
            [&](int64_t p) { return bin_of(p) <= best_plane; });
        mid = split - idx.data();
        if (mid == lo || mid == hi) mid = -1;
      }
    }
    if (mid < 0) {
      // degenerate centroids or failed SAH: median split (keeps leaves
      // bounded by leaf_size, same guarantee as the numpy builder)
      mid = lo + cnt / 2;
      std::nth_element(idx.data() + lo, idx.data() + mid, idx.data() + hi,
                       [&](int64_t a, int64_t b) {
                         return cent[3 * a + ax] < cent[3 * b + ax];
                       });
    }

    out_first[node] = 0;
    out_count[node] = 0;
    out_axis[node] = ax;
    // LIFO: pops left subtree first, then the patch, then the right subtree
    stack.push_back({mid, hi, t.depth + 1, false, -1});
    stack.push_back({0, 0, 0, true, node});
    stack.push_back({lo, mid, t.depth + 1, false, -1});
  }

  *out_max_depth = max_depth;
  return n_nodes;
}
