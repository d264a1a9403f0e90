// The SAH BVH builder of the PyTorch port: a copy of build_bvh_sah and
// its helpers in native/raytracing_native.cpp (the JAX package's native
// builder), so the two build the same tree node for node.
//
// Host code, not a device kernel: accel/native.py compiles it at first
// use with g++ and the reference's flags (-O3 -shared -fPIC -std=c++17)
// into build/native/ and binds it with ctypes; accel/bvh.py falls back to
// its numpy builder without g++.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SAH BVH build (reference: src/bvh.rs:215-337). PBRT-style bucketed SAH:
// <=5 primitives per leaf, 12 buckets, cost 0.125 + sum(count*SA)/SA,
// median-split fallback, z>y>x strict tie-break on the longest axis.
// Flat output layout: depth-first preorder, first child implicit at
// parent+1, payload = second-child index (interior) or primitive start
// (leaf). Returns node count, or -1 on error.

namespace {

constexpr int kMaxLeaf = 5;
constexpr int kBuckets = 12;

struct Builder {
    const float* mins;   // (n,3)
    const float* maxs;   // (n,3)
    std::vector<float> cx, cy, cz;      // centroids
    std::vector<int64_t> ids;           // permutation being partitioned
    // outputs
    float* nodes_min;    // (cap,3)
    float* nodes_max;
    int32_t* payload;
    int32_t* count;
    int32_t* axis_out;
    int32_t* order;      // (n,)
    int64_t node_len = 0;
    int64_t order_len = 0;
    int32_t max_depth = 0;

    float centroid(int64_t id, int ax) const {
        switch (ax) {
            case 0: return cx[id];
            case 1: return cy[id];
            default: return cz[id];
        }
    }

    // Float32 throughout, matching the numpy fallback's NEP-50
    // promotion (and the f32 Rust reference): double intermediates
    // would pick different buckets on near-tie splits and break the
    // order-identical invariant.
    static float surface_area(const float* bmin, const float* bmax) {
        const float dx = std::max(0.0f, bmax[0] - bmin[0]);
        const float dy = std::max(0.0f, bmax[1] - bmin[1]);
        const float dz = std::max(0.0f, bmax[2] - bmin[2]);
        return 2.0f * (dx * dy + dx * dz + dy * dz);
    }

    int64_t emit_leaf(int64_t lo, int64_t hi, const float* bmin, const float* bmax) {
        const int64_t slot = node_len++;
        std::memcpy(nodes_min + slot * 3, bmin, 3 * sizeof(float));
        std::memcpy(nodes_max + slot * 3, bmax, 3 * sizeof(float));
        payload[slot] = static_cast<int32_t>(order_len);
        count[slot] = static_cast<int32_t>(hi - lo);
        axis_out[slot] = 0;
        for (int64_t i = lo; i < hi; ++i)
            order[order_len++] = static_cast<int32_t>(ids[i]);
        return slot;
    }

    int64_t build(int64_t lo, int64_t hi, int depth) {
        max_depth = std::max(max_depth, depth);
        float bmin[3] = {1e30f, 1e30f, 1e30f};
        float bmax[3] = {-1e30f, -1e30f, -1e30f};
        for (int64_t i = lo; i < hi; ++i) {
            const int64_t id = ids[i];
            for (int k = 0; k < 3; ++k) {
                bmin[k] = std::min(bmin[k], mins[id * 3 + k]);
                bmax[k] = std::max(bmax[k], maxs[id * 3 + k]);
            }
        }
        const int64_t n_prims = hi - lo;
        // Recursion guard: a pathological SAH tree can approach O(n)
        // depth and overflow the C stack. Anything past the traversal
        // stack's 64 is already rejected by the Python caller
        // (accel/bvh.py), so degrading to a fat leaf here only changes
        // the error path from SIGSEGV to a clean ValueError.
        if (n_prims <= kMaxLeaf || depth >= 128)
            return emit_leaf(lo, hi, bmin, bmax);

        float cmin[3] = {1e30f, 1e30f, 1e30f};
        float cmax[3] = {-1e30f, -1e30f, -1e30f};
        for (int64_t i = lo; i < hi; ++i) {
            const int64_t id = ids[i];
            const float c[3] = {cx[id], cy[id], cz[id]};
            for (int k = 0; k < 3; ++k) {
                cmin[k] = std::min(cmin[k], c[k]);
                cmax[k] = std::max(cmax[k], c[k]);
            }
        }
        const float d[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
        int ax;
        if (d[2] > d[0] && d[2] > d[1]) ax = 2;
        else if (d[1] > d[0]) ax = 1;
        else ax = 0;
        if (cmin[ax] == cmax[ax]) return emit_leaf(lo, hi, bmin, bmax);

        auto bucket_of = [&](int64_t id) -> int {
            int b = static_cast<int>(kBuckets *
                ((centroid(id, ax) - cmin[ax]) / (cmax[ax] - cmin[ax])));
            return std::min(b, kBuckets - 1);
        };

        struct Bucket { int64_t count = 0; float bmin[3] = {1e30f,1e30f,1e30f}; float bmax[3] = {-1e30f,-1e30f,-1e30f}; };
        Bucket buckets[kBuckets];
        for (int64_t i = lo; i < hi; ++i) {
            const int64_t id = ids[i];
            Bucket& bk = buckets[bucket_of(id)];
            bk.count++;
            for (int k = 0; k < 3; ++k) {
                bk.bmin[k] = std::min(bk.bmin[k], mins[id * 3 + k]);
                bk.bmax[k] = std::max(bk.bmax[k], maxs[id * 3 + k]);
            }
        }

        float best_cost = 1e30f;
        int best_split = 0;
        const float sa_total = surface_area(bmin, bmax);
        for (int split = 0; split < kBuckets - 1; ++split) {
            float lmin[3] = {1e30f,1e30f,1e30f}, lmax[3] = {-1e30f,-1e30f,-1e30f};
            float rmin[3] = {1e30f,1e30f,1e30f}, rmax[3] = {-1e30f,-1e30f,-1e30f};
            int64_t lcount = 0, rcount = 0;
            for (int b = 0; b <= split; ++b) {
                if (!buckets[b].count) continue;
                lcount += buckets[b].count;
                for (int k = 0; k < 3; ++k) {
                    lmin[k] = std::min(lmin[k], buckets[b].bmin[k]);
                    lmax[k] = std::max(lmax[k], buckets[b].bmax[k]);
                }
            }
            for (int b = split + 1; b < kBuckets; ++b) {
                if (!buckets[b].count) continue;
                rcount += buckets[b].count;
                for (int k = 0; k < 3; ++k) {
                    rmin[k] = std::min(rmin[k], buckets[b].bmin[k]);
                    rmax[k] = std::max(rmax[k], buckets[b].bmax[k]);
                }
            }
            const float sa_l = lcount ? surface_area(lmin, lmax) : 0.0f;
            const float sa_r = rcount ? surface_area(rmin, rmax) : 0.0f;
            // f32 op order mirrors the numpy fallback exactly:
            // 0.125 + (cl*sa_l + cr*sa_r) / sa_total, first-min wins.
            const float cost = 0.125f +
                (static_cast<float>(lcount) * sa_l +
                 static_cast<float>(rcount) * sa_r) / sa_total;
            if (cost < best_cost) { best_cost = cost; best_split = split; }
        }

        // Partition in place by bucket <= best_split.
        int64_t mid = lo;
        int64_t end = hi;
        while (mid < end) {
            if (bucket_of(ids[mid]) <= best_split) ++mid;
            else std::swap(ids[mid], ids[--end]);
        }
        if (mid == lo || mid == hi) {
            // Median fallback.
            mid = lo + n_prims / 2;
            std::stable_sort(
                ids.begin() + lo, ids.begin() + hi,
                [&](int64_t a, int64_t b) {
                    return centroid(a, ax) < centroid(b, ax);
                });
        }

        const int64_t slot = node_len++;
        std::memcpy(nodes_min + slot * 3, bmin, 3 * sizeof(float));
        std::memcpy(nodes_max + slot * 3, bmax, 3 * sizeof(float));
        count[slot] = 0;
        axis_out[slot] = ax;
        build(lo, mid, depth + 1);  // first child at slot+1 implicitly
        const int64_t second = build(mid, hi, depth + 1);
        payload[slot] = static_cast<int32_t>(second);
        return slot;
    }
};

}  // namespace

// Caller allocates nodes_* with capacity 2n-1 (worst case), order with n.
// Returns node count; writes max depth to *out_depth.
int64_t build_bvh_sah(
    const float* mins,
    const float* maxs,
    int64_t n,
    float* nodes_min,
    float* nodes_max,
    int32_t* payload,
    int32_t* count,
    int32_t* axis_out,
    int32_t* order,
    int32_t* out_depth)
{
    if (n <= 0) return -1;
    Builder b;
    b.mins = mins;
    b.maxs = maxs;
    b.cx.resize(n); b.cy.resize(n); b.cz.resize(n);
    for (int64_t i = 0; i < n; ++i) {
        // (min + max) * 0.5 in f32, the numpy fallback's exact op order
        // (0.5*min + 0.5*max rounds differently and can flip buckets).
        b.cx[i] = (mins[i * 3 + 0] + maxs[i * 3 + 0]) * 0.5f;
        b.cy[i] = (mins[i * 3 + 1] + maxs[i * 3 + 1]) * 0.5f;
        b.cz[i] = (mins[i * 3 + 2] + maxs[i * 3 + 2]) * 0.5f;
    }
    b.ids.resize(n);
    for (int64_t i = 0; i < n; ++i) b.ids[i] = i;
    b.nodes_min = nodes_min;
    b.nodes_max = nodes_max;
    b.payload = payload;
    b.count = count;
    b.axis_out = axis_out;
    b.order = order;
    b.build(0, n, 0);
    *out_depth = b.max_depth;
    return b.node_len;
}


}  // extern "C"
