// Binned-SAH BVH builder over primitive AABBs (a copy of the JAX package's
// csrc/bvh.cpp: source_tpu_torch builds the same tree from its own sources).
//
// Native-host counterpart of the reference's kd-tree build
// (raysect/core/math/spatial/kdtree3d.pyx:166-393, SAH with PBRT-style
// auto depth) re-designed for stackless traversal: the output is a *threaded*
// flat array in depth-first order where every node stores its escape
// index (node + subtree size).  Device traversal then needs no stack:
//
//     next = (aabb hit && inner) ? node + 1 : skip[node]
//
// which maps onto one loop per ray thread (one node pointer per ray).  Leaf
// primitives are re-permuted into contiguous
// DFS ranges so leaves are (first, count) slices of one triangle array.
//
// Exposed as a C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Aabb {
    float lo[3];
    float hi[3];

    void reset() {
        for (int a = 0; a < 3; ++a) {
            lo[a] = 3.0e38f;
            hi[a] = -3.0e38f;
        }
    }
    void grow(const Aabb &o) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], o.lo[a]);
            hi[a] = std::max(hi[a], o.hi[a]);
        }
    }
    void grow_point(const float *p) {
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], p[a]);
            hi[a] = std::max(hi[a], p[a]);
        }
    }
    float half_area() const {
        float dx = std::max(0.0f, hi[0] - lo[0]);
        float dy = std::max(0.0f, hi[1] - lo[1]);
        float dz = std::max(0.0f, hi[2] - lo[2]);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct BuildNode {
    Aabb bounds;
    int32_t first = -1;   // leaf: first primitive in `order`
    int32_t count = 0;    // leaf: primitive count (0 => inner)
    int32_t left = -1;    // inner children (build-time indices)
    int32_t right = -1;
};

constexpr int kBins = 16;

struct Builder {
    const float *tri_lo;  // [n,3]
    const float *tri_hi;  // [n,3]
    int max_leaf;
    float traversal_cost;

    std::vector<Aabb> boxes;
    std::vector<float> centroid;  // [n,3]
    std::vector<int32_t> order;
    std::vector<BuildNode> nodes;

    int build(int n) {
        boxes.resize(n);
        centroid.resize(3 * size_t(n));
        order.resize(n);
        for (int i = 0; i < n; ++i) {
            order[i] = i;
            for (int a = 0; a < 3; ++a) {
                boxes[i].lo[a] = tri_lo[3 * size_t(i) + a];
                boxes[i].hi[a] = tri_hi[3 * size_t(i) + a];
                centroid[3 * size_t(i) + a] =
                    0.5f * (boxes[i].lo[a] + boxes[i].hi[a]);
            }
        }
        nodes.reserve(size_t(2) * n);
        return build_range(0, n);
    }

    int build_range(int first, int count) {
        int idx = int(nodes.size());
        nodes.emplace_back();
        Aabb bounds;
        bounds.reset();
        Aabb cbounds;
        cbounds.reset();
        for (int i = first; i < first + count; ++i) {
            bounds.grow(boxes[order[i]]);
            cbounds.grow_point(&centroid[3 * size_t(order[i])]);
        }
        nodes[idx].bounds = bounds;

        if (count <= max_leaf) {
            nodes[idx].first = first;
            nodes[idx].count = count;
            return idx;
        }

        // binned SAH over the widest centroid axis
        int axis = 0;
        float ext[3];
        for (int a = 0; a < 3; ++a) ext[a] = cbounds.hi[a] - cbounds.lo[a];
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int mid;
        if (ext[axis] <= 1e-12f) {
            mid = first + count / 2;  // degenerate: median split
        } else {
            Aabb bin_bounds[kBins];
            int bin_count[kBins] = {0};
            for (auto &b : bin_bounds) b.reset();
            const float scale = kBins / ext[axis];
            auto bin_of = [&](int prim) {
                int b = int((centroid[3 * size_t(prim) + axis] -
                             cbounds.lo[axis]) *
                            scale);
                return std::min(std::max(b, 0), kBins - 1);
            };
            for (int i = first; i < first + count; ++i) {
                int b = bin_of(order[i]);
                bin_count[b]++;
                bin_bounds[b].grow(boxes[order[i]]);
            }
            // sweep for best split
            float right_area[kBins];
            Aabb acc;
            acc.reset();
            int right_count[kBins];
            int rc = 0;
            for (int b = kBins - 1; b >= 1; --b) {
                acc.grow(bin_bounds[b]);
                rc += bin_count[b];
                right_area[b] = acc.half_area();
                right_count[b] = rc;
            }
            acc.reset();
            int lc = 0;
            float best_cost = 3.0e38f;
            int best_bin = -1;
            const float inv_root = 1.0f / std::max(bounds.half_area(), 1e-30f);
            for (int b = 0; b < kBins - 1; ++b) {
                acc.grow(bin_bounds[b]);
                lc += bin_count[b];
                if (lc == 0 || right_count[b + 1] == 0) continue;
                float cost =
                    traversal_cost +
                    (acc.half_area() * lc +
                     right_area[b + 1] * right_count[b + 1]) *
                        inv_root;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_bin = b;
                }
            }
            float leaf_cost = float(count);
            if (best_bin < 0 ||
                (best_cost >= leaf_cost && count <= 4 * max_leaf)) {
                nodes[idx].first = first;
                nodes[idx].count = count;
                return idx;
            }
            auto it = std::partition(
                order.begin() + first, order.begin() + first + count,
                [&](int prim) { return bin_of(prim) <= best_bin; });
            mid = int(it - order.begin());
            if (mid == first || mid == first + count)
                mid = first + count / 2;
        }

        nodes[idx].left = build_range(first, mid - first);
        nodes[idx].right = build_range(mid, first + count - mid);
        return idx;
    }

    // flatten to threaded DFS order
    void flatten(int node, float *out_lo, float *out_hi, int32_t *out_skip,
                 int32_t *out_first, int32_t *out_count, int32_t *cursor) {
        int32_t idx = (*cursor)++;
        const BuildNode &b = nodes[node];
        for (int a = 0; a < 3; ++a) {
            out_lo[3 * size_t(idx) + a] = b.bounds.lo[a];
            out_hi[3 * size_t(idx) + a] = b.bounds.hi[a];
        }
        out_first[idx] = b.count > 0 ? b.first : -1;
        out_count[idx] = b.count;
        if (b.count == 0) {
            flatten(b.left, out_lo, out_hi, out_skip, out_first, out_count,
                    cursor);
            flatten(b.right, out_lo, out_hi, out_skip, out_first, out_count,
                    cursor);
        }
        out_skip[idx] = *cursor;  // escape = index just past the subtree
    }
};

}  // namespace

extern "C" {

// Returns the number of flat nodes written (<= 2*n), or -1 on error.
// Output arrays must be sized for 2*n nodes; `out_order` for n entries.
int bvh_build(const float *tri_lo, const float *tri_hi, int n, int max_leaf,
              float traversal_cost, float *out_lo, float *out_hi,
              int32_t *out_skip, int32_t *out_first, int32_t *out_count,
              int32_t *out_order) {
    if (n <= 0 || max_leaf < 1) return -1;
    Builder b;
    b.tri_lo = tri_lo;
    b.tri_hi = tri_hi;
    b.max_leaf = max_leaf;
    b.traversal_cost = traversal_cost;
    int root = b.build(n);
    int32_t cursor = 0;
    b.flatten(root, out_lo, out_hi, out_skip, out_first, out_count, &cursor);
    std::memcpy(out_order, b.order.data(), sizeof(int32_t) * size_t(n));
    return cursor;
}

}  // extern "C"
