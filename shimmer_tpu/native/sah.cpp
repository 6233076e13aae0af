// Binned-SAH BVH builder (native).
//
// Analog of the reference's BVH build
// (/root/reference/src/aggregate.rs:207-419 — which only implements
// Middle/EqualCounts splits; SAH is its TODO at aggregate.rs:52).  The
// Python side (shimmer_tpu/ops/bvh8.py) collapses this binary hierarchy
// 8-wide and packs device rows; this builder exists because tree QUALITY
// sets the number of sequential row gathers per ray — the dominant
// traversal cost — and binned SAH visits ~1.5-2x fewer nodes than the
// Morton-split LBVH fallback.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image):
//   int build_sah_bvh(const float* lo, const float* hi, int n,
//                     int leaf_size, int bins,
//                     int* order, long long* node_l, long long* node_r,
//                     long long* left, long long* right,
//                     unsigned char* is_leaf, float* out_lo, float* out_hi)
// Output arrays must be sized 2n-1 (nodes) / n (order).  Returns the
// node count, or -1 on error.  Node 0 is the root; node ranges [l, r]
// index into `order`.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Box {
  float lo[3], hi[3];
  void reset() {
    lo[0] = lo[1] = lo[2] = FLT_MAX;
    hi[0] = hi[1] = hi[2] = -FLT_MAX;
  }
  void grow(const Box& b) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], b.lo[k]);
      hi[k] = std::max(hi[k], b.hi[k]);
    }
  }
  void grow_point(const float* p) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], p[k]);
      hi[k] = std::max(hi[k], p[k]);
    }
  }
  float half_area() const {
    float dx = std::max(0.0f, hi[0] - lo[0]);
    float dy = std::max(0.0f, hi[1] - lo[1]);
    float dz = std::max(0.0f, hi[2] - lo[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Task {
  int64_t node;
  int64_t l, r;  // inclusive range into order[]
};

}  // namespace

extern "C" int64_t build_sah_bvh(const float* lo, const float* hi,
                                 int64_t n, int leaf_size, int nbins,
                                 int32_t* order, int64_t* node_l,
                                 int64_t* node_r, int64_t* left,
                                 int64_t* right, uint8_t* is_leaf,
                                 float* out_lo, float* out_hi) {
  if (n <= 0 || leaf_size < 1 || nbins < 2 || nbins > 64) return -1;
  std::vector<Box> boxes(n);
  std::vector<float> centroid(3 * n);
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      boxes[i].lo[k] = lo[3 * i + k];
      boxes[i].hi[k] = hi[3 * i + k];
      centroid[3 * i + k] = 0.5f * (lo[3 * i + k] + hi[3 * i + k]);
    }
    order[i] = static_cast<int32_t>(i);
  }

  int64_t n_nodes = 0;
  std::vector<Task> stack;
  stack.reserve(128);

  auto alloc_node = [&](int64_t l, int64_t r) -> int64_t {
    int64_t id = n_nodes++;
    node_l[id] = l;
    node_r[id] = r;
    left[id] = -1;
    right[id] = -1;
    is_leaf[id] = 0;
    Box b;
    b.reset();
    for (int64_t i = l; i <= r; ++i) b.grow(boxes[order[i]]);
    std::memcpy(out_lo + 3 * id, b.lo, 12);
    std::memcpy(out_hi + 3 * id, b.hi, 12);
    return id;
  };

  stack.push_back({alloc_node(0, n - 1), 0, n - 1});

  std::vector<Box> bin_box(nbins);
  std::vector<int64_t> bin_cnt(nbins);
  std::vector<float> right_area(nbins);

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    int64_t count = t.r - t.l + 1;
    if (count <= leaf_size) {
      is_leaf[t.node] = 1;
      continue;
    }
    // Centroid bounds over the range.
    Box cb;
    cb.reset();
    for (int64_t i = t.l; i <= t.r; ++i)
      cb.grow_point(&centroid[3 * order[i]]);

    // Binned SAH over all three axes.
    int best_axis = -1, best_bin = -1;
    float best_cost = FLT_MAX;
    float parent_area = FLT_MAX;
    {
      Box pb;
      pb.reset();
      for (int64_t i = t.l; i <= t.r; ++i) pb.grow(boxes[order[i]]);
      parent_area = pb.half_area();
    }
    float best_cmin = 0, best_scale = 0;
    for (int axis = 0; axis < 3; ++axis) {
      float cmin = cb.lo[axis], cmax = cb.hi[axis];
      if (cmax - cmin < 1e-12f) continue;
      float scale = nbins / (cmax - cmin);
      for (int b = 0; b < nbins; ++b) {
        bin_box[b].reset();
        bin_cnt[b] = 0;
      }
      for (int64_t i = t.l; i <= t.r; ++i) {
        int32_t p = order[i];
        int b = std::min<int>(nbins - 1,
                              (int)((centroid[3 * p + axis] - cmin) * scale));
        bin_cnt[b]++;
        bin_box[b].grow(boxes[p]);
      }
      // Sweep right-to-left accumulating areas.
      Box acc;
      acc.reset();
      int64_t cnt = 0;
      for (int b = nbins - 1; b >= 1; --b) {
        acc.grow(bin_box[b]);
        cnt += bin_cnt[b];
        right_area[b] = (cnt > 0) ? acc.half_area() * cnt : 0.0f;
      }
      // Sweep left-to-right.
      acc.reset();
      cnt = 0;
      for (int b = 0; b < nbins - 1; ++b) {
        acc.grow(bin_box[b]);
        cnt += bin_cnt[b];
        if (cnt == 0 || cnt == count) continue;
        float cost = acc.half_area() * cnt + right_area[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
          best_cmin = cmin;
          best_scale = scale;
        }
      }
    }

    int64_t mid;
    if (best_axis < 0) {
      // Degenerate centroids: split equally.
      mid = t.l + count / 2 - 1;
    } else {
      // SAH leaf test (pbrt): cost of split vs leaf.
      float leaf_cost = (float)count;
      float split_cost = 0.125f + best_cost / parent_area;
      if (count <= leaf_size && leaf_cost <= split_cost) {
        is_leaf[t.node] = 1;
        continue;
      }
      int32_t* beg = order + t.l;
      int32_t* end = order + t.r + 1;
      int axis = best_axis;
      float cmin = best_cmin, scale = best_scale;
      int bb = best_bin;
      int32_t* pmid = std::partition(beg, end, [&](int32_t p) {
        int b = std::min<int>(nbins - 1,
                              (int)((centroid[3 * p + axis] - cmin) * scale));
        return b <= bb;
      });
      mid = t.l + (pmid - beg) - 1;
      if (mid < t.l || mid >= t.r) mid = t.l + count / 2 - 1;
    }

    int64_t lc = alloc_node(t.l, mid);
    int64_t rc = alloc_node(mid + 1, t.r);
    left[t.node] = lc;
    right[t.node] = rc;
    stack.push_back({rc, mid + 1, t.r});
    stack.push_back({lc, t.l, mid});
  }
  return n_nodes;
}
