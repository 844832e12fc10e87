// Native BVH builder: binned SAH over primitive AABBs, flattened to the
// escape-index DFS layout consumed by qt_raytracer/accel (see
// accel/bvh.py for the layout contract; this builder upgrades the split
// policy from centroid median to 16-bin surface-area heuristic).
//
// Replaces the host-side role of the reference's recursive pointer-tree
// builder (include/raytracer/RayTracer.h:393-429) with a production-grade
// native implementation: no shared_ptr graph, one contiguous output,
// SAH-quality trees for ~100k-triangle meshes in milliseconds.
//
// C ABI (ctypes-friendly):
//   int qtrt_build_bvh(const float* bb_min, const float* bb_max,
//                      int num_prims, int max_leaf,
//                      float* node_min, float* node_max, int* escape,
//                      int* prim_start, int* prim_count, int* prim_order);
// Output arrays must hold 2*num_prims-1 nodes (worst case); returns the
// actual node count, or -1 on invalid input.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Vec3f {
  float x, y, z;
};

inline Vec3f vmin(const Vec3f& a, const Vec3f& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3f vmax(const Vec3f& a, const Vec3f& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3f lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3f hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const Box& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3f& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float half_area() const {
    const float dx = std::max(0.0f, hi.x - lo.x);
    const float dy = std::max(0.0f, hi.y - lo.y);
    const float dz = std::max(0.0f, hi.z - lo.z);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Node {
  Box box;
  int32_t start = -1;   // leaf: first sorted-prim index
  int32_t count = 0;    // leaf: prim count (0 for inner)
  int32_t right = -1;   // inner: DFS index of right child
};

constexpr int kNumBins = 16;

class Builder {
 public:
  Builder(const float* bb_min, const float* bb_max, int n, int max_leaf)
      : n_(n), max_leaf_(std::max(1, max_leaf)) {
    boxes_.resize(n);
    centroids_.resize(n);
    for (int i = 0; i < n; ++i) {
      boxes_[i].lo = {bb_min[3 * i], bb_min[3 * i + 1], bb_min[3 * i + 2]};
      boxes_[i].hi = {bb_max[3 * i], bb_max[3 * i + 1], bb_max[3 * i + 2]};
      centroids_[i] = {0.5f * (boxes_[i].lo.x + boxes_[i].hi.x),
                       0.5f * (boxes_[i].lo.y + boxes_[i].hi.y),
                       0.5f * (boxes_[i].lo.z + boxes_[i].hi.z)};
    }
    ids_.resize(n);
    std::iota(ids_.begin(), ids_.end(), 0);
    order_.reserve(n);
    nodes_.reserve(2 * n);
    build(0, n);
  }

  const std::vector<Node>& nodes() const { return nodes_; }
  const std::vector<int32_t>& order() const { return order_; }

 private:
  // Build subtree over ids_[lo, hi); returns its root node index (DFS).
  int build(int lo, int hi) {
    const int my = static_cast<int>(nodes_.size());
    nodes_.emplace_back();
    Box bounds;
    for (int i = lo; i < hi; ++i) bounds.grow(boxes_[ids_[i]]);
    nodes_[my].box = bounds;

    const int count = hi - lo;
    if (count <= max_leaf_) {
      make_leaf(my, lo, hi);
      return my;
    }

    // Centroid bounds pick the bin axis.
    Box cb;
    for (int i = lo; i < hi; ++i) cb.grow(centroids_[ids_[i]]);
    const float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y,
                          cb.hi.z - cb.lo.z};
    const int axis = (ext[0] >= ext[1] && ext[0] >= ext[2]) ? 0
                     : (ext[1] >= ext[2])                   ? 1
                                                            : 2;
    const float cmin = axis == 0 ? cb.lo.x : axis == 1 ? cb.lo.y : cb.lo.z;
    const float extent = ext[axis];

    int mid;
    if (extent <= 1e-12f) {
      mid = lo + count / 2;  // degenerate: all centroids equal -> median
    } else {
      // Binned SAH.
      Box bin_box[kNumBins];
      int bin_cnt[kNumBins] = {0};
      const float scale = kNumBins / extent;
      auto bin_of = [&](int id) {
        const Vec3f& c = centroids_[id];
        const float v = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
        int b = static_cast<int>((v - cmin) * scale);
        return std::min(std::max(b, 0), kNumBins - 1);
      };
      for (int i = lo; i < hi; ++i) {
        const int b = bin_of(ids_[i]);
        bin_box[b].grow(boxes_[ids_[i]]);
        ++bin_cnt[b];
      }
      // Sweep: suffix areas then prefix scan for best split.
      float right_area[kNumBins];
      Box acc;
      int acc_cnt = 0;
      for (int b = kNumBins - 1; b > 0; --b) {
        acc.grow(bin_box[b]);
        right_area[b] = acc.half_area();
      }
      Box lacc;
      int lcnt = 0;
      float best_cost = FLT_MAX;
      int best_bin = -1;
      int right_cnt_total = count;
      for (int b = 0; b < kNumBins - 1; ++b) {
        lacc.grow(bin_box[b]);
        lcnt += bin_cnt[b];
        if (lcnt == 0 || lcnt == count) continue;
        const float cost = lacc.half_area() * lcnt +
                           right_area[b + 1] * (count - lcnt);
        if (cost < best_cost) {
          best_cost = cost;
          best_bin = b;
        }
      }
      (void)acc_cnt;
      (void)right_cnt_total;
      if (best_bin < 0) {
        mid = lo + count / 2;
        std::nth_element(ids_.begin() + lo, ids_.begin() + mid,
                         ids_.begin() + hi, [&](int a, int b) {
                           const Vec3f& ca = centroids_[a];
                           const Vec3f& cbv = centroids_[b];
                           const float va = axis == 0   ? ca.x
                                            : axis == 1 ? ca.y
                                                        : ca.z;
                           const float vb = axis == 0   ? cbv.x
                                            : axis == 1 ? cbv.y
                                                        : cbv.z;
                           return va < vb;
                         });
      } else {
        auto it = std::partition(ids_.begin() + lo, ids_.begin() + hi,
                                 [&](int id) { return bin_of(id) <= best_bin; });
        mid = static_cast<int>(it - ids_.begin());
        if (mid == lo || mid == hi) mid = lo + count / 2;  // safety
      }
    }

    build(lo, mid);                       // left subtree = my + 1
    nodes_[my].right = build(mid, hi);    // right subtree root
    return my;
  }

  void make_leaf(int node, int lo, int hi) {
    nodes_[node].start = static_cast<int32_t>(order_.size());
    nodes_[node].count = hi - lo;
    for (int i = lo; i < hi; ++i) order_.push_back(ids_[i]);
  }

  int n_, max_leaf_;
  std::vector<Box> boxes_;
  std::vector<Vec3f> centroids_;
  std::vector<int> ids_;
  std::vector<Node> nodes_;
  std::vector<int32_t> order_;
};

void fill_escape(const std::vector<Node>& nodes, int i, int esc,
                 int32_t* escape) {
  // Iterative DFS (explicit stack) — meshes can be deep.
  std::vector<std::pair<int, int>> stack{{i, esc}};
  while (!stack.empty()) {
    auto [node, e] = stack.back();
    stack.pop_back();
    escape[node] = e;
    if (nodes[node].count == 0) {
      const int right = nodes[node].right;
      stack.emplace_back(node + 1, right);  // left escapes to right subtree
      stack.emplace_back(right, e);         // right escapes to parent's esc
    }
  }
}

}  // namespace

extern "C" {

int qtrt_build_bvh(const float* bb_min, const float* bb_max, int num_prims,
                   int max_leaf, float* node_min, float* node_max,
                   int32_t* escape, int32_t* prim_start, int32_t* prim_count,
                   int32_t* prim_order) {
  if (num_prims <= 0 || !bb_min || !bb_max) return -1;
  Builder b(bb_min, bb_max, num_prims, max_leaf);
  const auto& nodes = b.nodes();
  const int m = static_cast<int>(nodes.size());
  for (int i = 0; i < m; ++i) {
    node_min[3 * i] = nodes[i].box.lo.x;
    node_min[3 * i + 1] = nodes[i].box.lo.y;
    node_min[3 * i + 2] = nodes[i].box.lo.z;
    node_max[3 * i] = nodes[i].box.hi.x;
    node_max[3 * i + 1] = nodes[i].box.hi.y;
    node_max[3 * i + 2] = nodes[i].box.hi.z;
    prim_start[i] = nodes[i].count > 0 ? nodes[i].start : -1;
    prim_count[i] = nodes[i].count;
  }
  fill_escape(nodes, 0, m, escape);
  std::memcpy(prim_order, b.order().data(),
              sizeof(int32_t) * static_cast<size_t>(num_prims));
  return m;
}

}  // extern "C"
