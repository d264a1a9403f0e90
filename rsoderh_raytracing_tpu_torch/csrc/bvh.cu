// BVH_CLOSEST and BVH_ANY: the BVH route's walks, one thread a lane.
//
// The JAX package has no Pallas kernel for these: it walks its flat BVH
// in XLA (rsoderh_raytracing_tpu/ops/bvh_traverse.py: traverse_closest at
// :304 and traverse_any at :468, each a lax.while_loop that advances every
// ray one node a trip), and intersect._sweep_bvh adds the linear sphere
// and plane fallback on a miss. The reference renderer's shader walks
// one ray a thread with a 64-deep stack (shader.wgsl:469-564), and so do
// these kernels:
//   BVH_CLOSEST  per lane the walk of traverse_closest (best-t pruning,
//                both children's boxes tested at the parent, the near one
//                first by the sign of 1/rd on the node's split axis, the
//                far one pushed with its slab entry time and skipped when
//                popped if that entry is past the best t, leaf slots in
//                slot order with a strict < winner), then on a miss the
//                sphere and plane sweep over the valid rows
//                (wavefront_common.cuh:sweep, the rows of pack_rows); writes (t, type, index), a miss
//                (3e38, -1, 0);
//   BVH_ANY      the same walk without a best t, stopping at the first
//                hit; no fallback (the reference's occlusion has none).
// Lanes outside the int32 mask (null: every lane) get the miss record or
// 0. The plain twins are ops/bvh.py: closest_plain and any_plain.
//
// Numbers. The leaf tests are the reference's direct formulas
// (_sphere_t, _plane_t, _triangle_t), not the sweep's expanded ones; sums
// of three products are written left to right, as the plain twins write
// them, and the build has -fmad=false and IEEE division and square root,
// so t, type and index are bitwise the plain twins'. The slab test drops
// a NaN axis ((b - o) * inf with b == o) explicitly: entry 0 and exit
// 3e38 for that axis, as geometry.ray_bounds_entry does after
// jnp.minimum/maximum propagate the NaN (fminf/fmaxf would drop the NaN
// operand and give another box).
//
// Tables (ops/bvh.py): a node is three 16-byte words (min xyz, payload |
// max xyz, count | axis, -, -, -), the integers bit-cast into float
// lanes; a leaf slot four (the reference's _prim_table row, type tag in
// column 15). Both are read through the read-only cache (__ldg).
//
// What bounds them on the H100. Every lane walks its own path, so a warp
// diverges at every node and reads rows no neighbour reads: the work is
// per-lane box and leaf tests (operations), and the rows come from L2 or
// device memory one lane at a time. The stack is 64 node indices and 64
// entry times a thread (512 B of local memory). This first version makes
// no attempt at coherence (no ray binning, no short or shared stack, no
// packed 32-byte nodes): ROADMAP queue 2 lists those.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "wavefront_common.cuh"

using namespace rt;

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;  // accel/bvh.py: TRAVERSAL_STACK_DEPTH

struct Tree {
  const float4* __restrict__ nodes;  // 3 words a node
  const float4* __restrict__ prims;  // 4 words a leaf slot
};

struct Walker {
  float o[3], d[3], inv[3];
};

__device__ __forceinline__ Walker walker(const Ray& r) {
  Walker w;
  w.o[0] = r.ox; w.o[1] = r.oy; w.o[2] = r.oz;
  w.d[0] = r.dx; w.d[1] = r.dy; w.d[2] = r.dz;
  w.inv[0] = 1.0f / r.dx;
  w.inv[1] = 1.0f / r.dy;
  w.inv[2] = 1.0f / r.dz;
  return w;
}

// One axis of the slab test: the slab times' NaN-propagating min and max,
// a NaN axis left without a constraint (entry 0, exit 3e38), the entry
// clamped at 0.
__device__ __forceinline__ void slab_axis(float lo, float hi, float o, float inv, float& t_lo,
                                          float& t_hi) {
  const float near = (lo - o) * inv;
  const float far = (hi - o) * inv;
  const float a = minn(near, far), b = maxn(near, far);
  t_lo = isnan_(a) ? 0.0f : maxn(a, 0.0f);
  t_hi = isnan_(b) ? INF : b;
}

// geometry.ray_bounds_entry against node k's box: returns t0 <= t1 and
// the entry t0.
__device__ __forceinline__ bool slab(const Tree& tree, int k, const Walker& w, float& t0) {
  const float4 lo = __ldg(tree.nodes + 3 * k);
  const float4 hi = __ldg(tree.nodes + 3 * k + 1);
  float l0, l1, l2, h0, h1, h2;
  slab_axis(lo.x, hi.x, w.o[0], w.inv[0], l0, h0);
  slab_axis(lo.y, hi.y, w.o[1], w.inv[1], l1, h1);
  slab_axis(lo.z, hi.z, w.o[2], w.inv[2], l2, h2);
  t0 = maxn(maxn(l0, l1), l2);
  const float t1 = minn(minn(h0, h1), h2);
  return t0 <= t1;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// bvh_traverse._sphere_t: centre c, radius rad.
__device__ __forceinline__ float sphere_t(const Walker& w, float cx, float cy, float cz,
                                          float rad) {
  const float lx = w.o[0] - cx, ly = w.o[1] - cy, lz = w.o[2] - cz;
  const float a = dot3(w.d[0], w.d[1], w.d[2], w.d[0], w.d[1], w.d[2]);
  const float b = 2.0f * dot3(w.d[0], w.d[1], w.d[2], lx, ly, lz);
  const float c = dot3(lx, ly, lz, lx, ly, lz) - rad * rad;
  const float disc = b * b - 4.0f * a * c;
  const float sq = sqrtf(maxn(disc, 0.0f));
  const float q = b > 0.0f ? -0.5f * (b + sq) : -0.5f * (b - sq);
  const float t0 = q / a;
  const float t1 = c / (q == 0.0f ? 1.0f : q);
  float t = t0 < SPHERE_EPS ? t1 : (t1 < SPHERE_EPS ? t0 : minn(t0, t1));
  if (disc == 0.0f) t = -0.5f * b / a;
  return (disc >= 0.0f && t >= SPHERE_EPS) ? t : INF;
}

// bvh_traverse._plane_t: pos p, normal n, base-change rows 0 and 2.
__device__ __forceinline__ float plane_t(const Walker& w, float4 r0, float4 r1, float4 r2,
                                         float4 r3) {
  const float px = r0.x, py = r0.y, pz = r0.z, nx = r0.w, ny = r1.x, nz = r1.y;
  const float denom = dot3(nx, ny, nz, w.d[0], w.d[1], w.d[2]);
  const bool ok = fabsf(denom) >= PLANE_DENOM_EPS;
  const float t =
      dot3(nx, ny, nz, px - w.o[0], py - w.o[1], pz - w.o[2]) / (ok ? denom : 1.0f);
  const float ix = w.o[0] + w.d[0] * t - px;
  const float iy = w.o[1] + w.d[1] * t - py;
  const float iz = w.o[2] + w.d[2] * t - pz;
  const float x = dot3(r1.z, r1.w, r2.x, ix, iy, iz);  // bcm row 0: columns 6-8
  const float z = dot3(r3.x, r3.y, r3.z, ix, iy, iz);  // bcm row 2: columns 12-14
  const bool hit = ok && (t >= PLANE_T_EPS) && (x >= 0.0f) && (x <= 1.0f) && (z >= 0.0f) &&
                   (z <= 1.0f);
  return hit ? t : INF;
}

// bvh_traverse._triangle_t: corner a, edges e0, e1.
__device__ __forceinline__ float triangle_t(const Walker& w, float4 r0, float4 r1, float4 r2) {
  const float ax = r0.x, ay = r0.y, az = r0.z;
  const float e0x = r0.w, e0y = r1.x, e0z = r1.y;
  const float e1x = r1.z, e1y = r1.w, e1z = r2.x;
  const float rx = w.o[0] - ax, ry = w.o[1] - ay, rz = w.o[2] - az;
  const float p0x = ry * e0z - rz * e0y, p0y = rz * e0x - rx * e0z, p0z = rx * e0y - ry * e0x;
  const float p1x = w.d[1] * e1z - w.d[2] * e1y, p1y = w.d[2] * e1x - w.d[0] * e1z,
              p1z = w.d[0] * e1y - w.d[1] * e1x;
  const float det = dot3(e0x, e0y, e0z, p1x, p1y, p1z);
  const bool ok = fabsf(det) >= TRI_DET_EPS;
  const float inv = 1.0f / (ok ? det : 1.0f);
  const float u = dot3(rx, ry, rz, p1x, p1y, p1z) * inv;
  const float v = dot3(w.d[0], w.d[1], w.d[2], p0x, p0y, p0z) * inv;
  const float t = dot3(e1x, e1y, e1z, p0x, p0y, p0z) * inv;
  const bool hit = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                   (t >= TRI_T_EPS);
  return hit ? t : INF;
}

// The leaf test of slot s: its row's kind (column 15) picks the test.
__device__ __forceinline__ float leaf_t(const Tree& tree, int s, const Walker& w) {
  const float4* row = tree.prims + 4 * s;
  const float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2), r3 = __ldg(row + 3);
  const int kind = __float_as_int(r3.w);
  if (kind == 2) return triangle_t(w, r0, r1, r2);
  if (kind == 1) return plane_t(w, r0, r1, r2, r3);
  if (kind == 0) return sphere_t(w, r0.x, r0.y, r0.z, r0.w);
  return INF;
}

// Node k's payload (second child or first slot), count and split axis.
struct NodeMeta {
  int payload, count, axis;
};

__device__ __forceinline__ NodeMeta meta(const Tree& tree, int k) {
  const float4 m0 = __ldg(tree.nodes + 3 * k);
  const float4 m1 = __ldg(tree.nodes + 3 * k + 1);
  const float4 m2 = __ldg(tree.nodes + 3 * k + 2);
  return NodeMeta{__float_as_int(m0.w), __float_as_int(m1.w), __float_as_int(m2.x)};
}

// The walk of traverse_closest (kClosest) or traverse_any. Returns the
// winning slot (-1: none) and its t in best_t; traverse_any's walk
// returns the first slot that hits.
template <bool kClosest>
__device__ __forceinline__ int walk(const Tree& tree, const Walker& w, float& best_t) {
  best_t = INF;
  int best_slot = -1;
  float entry;
  if (!slab(tree, 0, w, entry)) return -1;
  int stack[kStack];
  float tstack[kStack];
  int sp = 0;
  int cur = 0;
  float cur_entry = 0.0f;
  while (true) {
    bool has_child = false;
    int descend = 0;
    float descend_entry = 0.0f;
    if (!kClosest || cur_entry <= best_t) {
      const NodeMeta m = meta(tree, cur);
      if (m.count > 0) {
        for (int j = 0; j < m.count; ++j) {
          const float t = leaf_t(tree, m.payload + j, w);
          if (t < best_t) {
            best_t = t;
            best_slot = m.payload + j;
            if (!kClosest) return best_slot;
          }
        }
      } else {
        const float inv_axis = m.axis == 0 ? w.inv[0] : (m.axis == 1 ? w.inv[1] : w.inv[2]);
        const bool neg = inv_axis < 0.0f;
        const int near = neg ? m.payload : cur + 1;
        const int far = neg ? cur + 1 : m.payload;
        float n_entry, f_entry;
        bool hit_n = slab(tree, near, w, n_entry);
        bool hit_f = slab(tree, far, w, f_entry);
        if (kClosest) {
          hit_n = hit_n && n_entry <= best_t;
          hit_f = hit_f && f_entry <= best_t;
        }
        if (hit_n && hit_f) {
          const int k = min(sp, kStack - 1);
          stack[k] = far;
          tstack[k] = f_entry;
          ++sp;
        }
        has_child = hit_n || hit_f;
        descend = hit_n ? near : far;
        descend_entry = hit_n ? n_entry : f_entry;
      }
    }
    if (has_child) {
      cur = descend;
      cur_entry = descend_entry;
    } else if (sp > 0) {
      --sp;
      const int k = clampi(sp, 0, kStack - 1);
      cur = stack[k];
      cur_entry = tstack[k];
    } else {
      break;
    }
  }
  return best_slot;
}

struct RayPtrs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
};

__device__ __forceinline__ Ray load_ray(const RayPtrs& r, int i) {
  return Ray{r.ox[i], r.oy[i], r.oz[i], r.dx[i], r.dy[i], r.dz[i]};
}

struct ClosestArgs {
  RayPtrs r;
  const int32_t* live;  // may be null: every lane
  float* t;
  int32_t* type;
  int32_t* index;
};

struct AnyArgs {
  RayPtrs r;
  const int32_t* mask;  // may be null: every lane
  int32_t* occ;
};

__global__ void __launch_bounds__(kThreads)
    bvh_closest_kernel(ClosestArgs a, Tree tree, const int32_t* __restrict__ prim_type,
                       const int32_t* __restrict__ prim_index, const float* __restrict__ small,
                       int n_sph, int rows_sph, int rows_pln, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float t = INF;
  int type = -1, idx = 0;
  if (a.live == nullptr || a.live[i] != 0) {
    const Ray r = load_ray(a.r, i);
    float best_t;
    const int slot = walk<true>(tree, walker(r), best_t);
    if (slot >= 0) {
      t = best_t;
      type = __ldg(prim_type + slot);
      idx = __ldg(prim_index + slot);
    } else {
      SceneView s;
      s.sph = small;
      s.pln = small + n_sph * SPH_COLS;
      s.tri = nullptr;
      s.mat = nullptr;
      s.n_sph = rows_sph;
      s.n_pln = rows_pln;
      s.n_tri = 0;
      s.n_mat = 0;
      sweep(s, r, false, t, type, idx);
    }
  }
  a.t[i] = t;
  a.type[i] = type;
  a.index[i] = idx;
}

__global__ void __launch_bounds__(kThreads) bvh_any_kernel(AnyArgs a, Tree tree, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  int occ = 0;
  if (a.mask == nullptr || a.mask[i] != 0) {
    float best_t;
    occ = walk<false>(tree, walker(load_ray(a.r, i)), best_t) >= 0 ? 1 : 0;
  }
  a.occ[i] = occ;
}

}  // namespace

extern "C" {

// p: 10 device pointers, ClosestArgs field order (6 f32 ray inputs, the
// i32 live mask or null, t f32, type i32, index i32). nodes (K, 12) and
// prims (R, 16) f32, prim_type and prim_index (R,) i32, small the sphere
// and plane rows of the miss fallback (n_sph sphere rows, then the
// planes); the fallback sweeps the first rows_sph spheres and rows_pln
// planes (the valid ones: DeviceScene.sweep_rows).
int rt_bvh_closest_launch(void** p, const float* nodes, const float* prims,
                          const int32_t* prim_type, const int32_t* prim_index,
                          const float* small, int n_sph, int rows_sph, int rows_pln, int n,
                          void* stream) {
  static_assert(sizeof(ClosestArgs) == 10 * sizeof(void*), "ClosestArgs layout");
  ClosestArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  const Tree tree{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(prims)};
  bvh_closest_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      a, tree, prim_type, prim_index, small, n_sph, rows_sph, rows_pln, n);
  return (int)cudaGetLastError();
}

// p: 8 device pointers, AnyArgs field order (6 f32 ray inputs, the i32
// mask or null, occ i32); tables as for BVH_CLOSEST.
int rt_bvh_any_launch(void** p, const float* nodes, const float* prims, int n, void* stream) {
  static_assert(sizeof(AnyArgs) == 8 * sizeof(void*), "AnyArgs layout");
  AnyArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  const Tree tree{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(prims)};
  bvh_any_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(a, tree,
                                                                                      n);
  return (int)cudaGetLastError();
}

}  // extern "C"
