// BVH_CLOSEST and BVH_ANY: the BVH route's walks, for the H100.
//
// The JAX package has no Pallas kernel for these: it walks its flat BVH
// in XLA (rsoderh_raytracing_tpu/ops/bvh_traverse.py: traverse_closest at
// :304 and traverse_any at :468, each a lax.while_loop that advances every
// ray one node a trip), and intersect._sweep_bvh adds the linear sphere
// and plane fallback on a miss.
//   BVH_CLOSEST  per ray the walk of traverse_closest, step for step
//                (best-t pruning, both children's boxes tested at the
//                parent, the near one first by the sign of 1/rd on the
//                node's split axis, the far one pushed with its slab entry
//                time and skipped when popped if that entry is past the
//                best t, leaf slots in slot order with a strict < winner),
//                then on a miss the sphere and plane sweep over the valid
//                rows (wavefront_common.cuh:sweep's arithmetic, in
//                fallback_kernel);
//                writes (t, type, index), a miss (3e38, -1, 0), and adds
//                the lanes the sweep took to the caller's int64 counter;
//   BVH_ANY      the same walk without a best t, stopping at the first
//                hit; no fallback (the reference's occlusion has none).
//                Its rays are the shadow rays of the closest hits: a lane
//                whose closest ray hit (type >= 0) and is in a path walks
//                from ro + rd * t (a multiply, then an add, as the
//                reference's glue rounds it, render/wavefront.py:991-998)
//                along the NEE direction, so no tensor code runs between
//                the walks.
// Lanes outside BVH_CLOSEST's int32 mask (null: every lane) get the miss
// record, and lanes without a shadow ray 0. The plain twins are ops/bvh.py:
// closest_plain and any_plain;
// ops/bvh.walk_model walks the child-pair rows as these kernels walk each
// ray, in lane order, and gives the twins' outputs and counts exactly.
//
// Numbers. The leaf tests are the reference's direct formulas
// (_sphere_t, _plane_t, _triangle_t), not the sweep's expanded ones; sums
// of three products are written left to right, as the plain twins write
// them, and the build has -fmad=false and IEEE division and square root,
// so t, type and index are bitwise the plain twins'. The slab test keeps
// the reference's NaN rule (a NaN axis is unconstrained: entry 0, exit
// 3e38); see slab_axis.
//
// Tables (ops/bvh.py). An interior node's child-pair row (pair_table):
// 64 bytes, both children's boxes (the node table's floats, bit for bit),
// each child's reference (its row, or for a leaf ~(first slot << 3 |
// count)) and the split axis, so a visit is four 16-byte reads of one
// aligned row and a leaf child needs no node read. The root's box from
// the node table. A leaf slot's four 16-byte words (the reference's
// _prim_table row, type tag in column 15). All through the read-only
// cache (__ldg).
//
// The design. Persistent warps: as many 128-thread blocks as the SMs
// hold; a warp takes the next lanes from a counter (lane 0's atomicAdd,
// then __shfl_sync) whenever 8 or more of its lanes are idle, so a walk,
// whose length varies more than 10x from lane to lane, no longer holds a
// warp to its longest lane, and a lane off the mask or outside the root's
// box is answered at once. The while-while loop of Aila and Laine (HPG
// 2009): a warp runs interior nodes until each lane wants a leaf or is
// done, then tests the leaves; which thread walks which ray, and when,
// changes, each ray's order does not. The stack: 64 entries a thread in
// local memory, clamped as the reference clamps it (the tree's depth
// bounds its use; the wrapper raises on a deeper tree).
//
// BVH_CLOSEST's fallback sweep is a second pass (fallback_kernel), so a
// sweep of hundreds of rows never holds up a warp's walks. The walk marks
// the lanes it misses pending, scattered among those it answered: one
// thread a lane in lane order swept rtiow_final's in warps 51% full in
// the benchmark's captured iteration, 29% in profiling.py's loop state
// (profiling.fallback_report). So the pass runs as many 256-thread blocks
// as the SMs hold. Each stages the valid rows in shared memory once (a
// sphere's (pos c2) word, a plane's four words; over 14,000 spheres it
// reads them from global memory instead), takes tiles of 1,024 lanes in
// lane order from a counter, packs each tile's pending lanes into a ring
// in shared memory (a ballot a warp and a prefix over the tile's 32
// (step, warp) counts, as sweep.cu's compact_block), and sweeps the ring
// 256 lanes at a time, so every sweeping warp is full but each block's
// last. A lane that is not pending is read no further than its type. Each
// block adds its pending lanes to the caller's counter once, at its end.
//
// What bounds them on the H100. The published count is operations (box
// and leaf tests; profiling.bvh_bound): 0.0839 and 0.0703 ms on a 2048^2
// suzanne_xxhi loop state, against 1.28 and 1.37 ms (6.5% and 5.1%).
// BVH_ANY reads each lane's type and, on a hit lane, in_path, t, the
// closest ray and the NEE direction: 12 four-byte values where it read 7
// (the mask, the hit point and the direction), a few hundredths of a ms at
// 4.2M lanes.
// Warps still diverge on box hits and leaf sizes, a box test issues about
// twice the counted operations (the NaN rule, the near/far selects), and
// the leaf rows (60.5 MiB) do not fit the 50 MB L2.
//
// The fallback pass is bound by operations too: 38 a sphere row and 33 a
// plane row for each pending lane (profiling.fallback_bound, counted as
// portbench/counts.py counts them). In rtiow_final.render's captured
// iteration, 2,152,129 pending lanes over 486 spheres and a plane: 0.5943
// ms, against 0.7278 ms an iteration in the traced run (82%; 1.9091 ms,
// 31%, one thread a lane in lane order). What is left is instruction
// throughput: under -fmad=false a sphere that fails the pre-test, as most
// do, still costs about 20 f32 instructions, its shared-memory load and
// the loop's own.
// suzanne_xhi's pass (one plane row) reads the lanes' types and the
// pending rays: 0.0622 ms an iteration (0.0600 before), not worth a path
// of its own.
//
// Levers, each timed in one call against the first version's one thread
// a ray on the node table (2.93 / 2.44 ms), BVH_CLOSEST / BVH_ANY ms
// (PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W):
//   child-pair rows and the cheaper slab test together, one thread a ray:
//     1.83 / 1.95
//   + while-while: 1.74 / 2.05 (kept only with persistence)
//   lane packing passes (count, then scatter lane ids into 8 lists), one
//     thread a lane: lane order 1.92 / 1.82, by direction octant 1.84 /
//     2.06; with persistent warps 1.37 / 1.37 and 1.43 / 1.47: dropped
//     (the refill already skips idle lanes; the passes cost more than the
//     coherence buys)
//   a depth-sized shared-memory stack ([entry][thread]): 1.34 / 1.40
//     against the local stack's 1.28 / 1.37: dropped
//   persistent warps that refill at 32 / 16 / 8 idle lanes: 1.61 / 1.97,
//     1.29 / 1.42, 1.28 / 1.37: kept at 8; the one-node-a-trip loop
//     there 1.48 / 1.39: dropped
// Also tried and removed (no faster): a register cap for 12 or 16 blocks
// an SM, evict-first leaf reads.
//
// The fallback pass's levers, each timed in one call against one thread a
// lane in lane order (1.9686 / 1.9791 ms; suzanne_xhi 0.0540 / 0.0542), ms
// a launch on a 2048^2 rtiow_final loop state of profiling.py's (1,099,344
// pending lanes, 29% warp fill in lane order) and on suzanne_xhi's:
//   packing alone, the rows read from global memory: 0.7873 / 0.7961
//     (suzanne_xhi 0.0514 / 0.0509)
//   staging alone, each tile's pending lanes swept where they lie:
//     1.8806 / 1.8188 (0.0560 / 0.0560)
//   both, a staged sphere row as two words (the valid flag read apart):
//     0.6390 / 0.6374, 56 registers (an earlier call, parent 1.9727 /
//     1.9742); both, a sphere row as one word: 0.5817 / 0.5925, 48
//     registers (0.0509 / 0.0509): kept
//   fixed contiguous ranges of tiles in place of the counter: 1.1411 /
//     1.1472 (the sky's lanes leave blocks idle at the end): dropped
//   __launch_bounds__ for 5 or 6 blocks an SM (two-word rows): 0.6492 /
//     0.6376, 0.6617 / 0.6720: dropped
//
// Registers (-Xptxas -v): BVH_CLOSEST's walk 44 and a 512-byte stack
// frame, BVH_ANY's 45 and 256 bytes, the fallback pass 48 (staged or not)
// and 8,336 bytes of static shared memory; no spills.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "wavefront_common.cuh"

using namespace rt;

namespace {

constexpr int kThreads = 128;       // a walk block
constexpr int kSweepThreads = 256;  // a block of BVH_CLOSEST's fallback pass
constexpr int kMaxStack = 64;       // accel/bvh.py: TRAVERSAL_STACK_DEPTH
constexpr int kRefill = 8;          // the idle lanes that make a warp take more rays
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Tree {
  const float4* __restrict__ nodes;  // 3 words a node; the walk reads the root's box
  const float4* __restrict__ pairs;  // 4 words an interior node: its children's boxes
  const float4* __restrict__ prims;  // 4 words a leaf slot
  int root;  // the root's reference (an interior row, or ~(slot << 3 | count))
};

struct Walker {
  float o[3], d[3], inv[3];
  bool finite;  // o finite and 0 < |inv| < inf on every axis: no slab time can be NaN
};

__device__ __forceinline__ bool finite_ray(float o, float inv) {
  return fabsf(o) < INFINITY && fabsf(inv) > 0.0f && fabsf(inv) < INFINITY;
}

__device__ __forceinline__ Walker walker(const Ray& r) {
  Walker w;
  w.o[0] = r.ox; w.o[1] = r.oy; w.o[2] = r.oz;
  w.d[0] = r.dx; w.d[1] = r.dy; w.d[2] = r.dz;
  w.inv[0] = 1.0f / r.dx;
  w.inv[1] = 1.0f / r.dy;
  w.inv[2] = 1.0f / r.dz;
  w.finite = finite_ray(r.ox, w.inv[0]) && finite_ray(r.oy, w.inv[1]) && finite_ray(r.oz, w.inv[2]);
  return w;
}

// One axis of the slab test: the slab times' NaN-propagating min and max,
// a NaN axis left without a constraint (entry 0, exit 3e38), the entry
// clamped at 0. A NaN in either slab time leaves the axis unconstrained,
// so both times are tested once, and otherwise the min and max of two
// numbers are plain fminf/fmaxf (a -0 entry for +0 changes no comparison). A slab time is NaN only for
// 0 * inf or inf * 0 (the origin on the slab's plane with a zero
// direction component, or an infinite one) or a NaN origin, so kChecked =
// false skips the test for a ray whose origin is finite and whose
// reciprocals are finite and non-zero (Walker::finite).
template <bool kChecked>
__device__ __forceinline__ void slab_axis(float lo, float hi, float o, float inv, float& t_lo,
                                          float& t_hi) {
  const float near = (lo - o) * inv;
  const float far = (hi - o) * inv;
  const bool free_axis = kChecked && (isnan_(near) || isnan_(far));
  t_lo = free_axis ? 0.0f : fmaxf(fminf(near, far), 0.0f);
  t_hi = free_axis ? INF : fmaxf(near, far);
}

// geometry.ray_bounds_entry against the box (lo, hi): returns t0 <= t1
// and the entry t0.
template <bool kChecked>
__device__ __forceinline__ bool slab_of(float4 lo, float4 hi, const Walker& w, float& t0) {
  float l0, l1, l2, h0, h1, h2;
  slab_axis<kChecked>(lo.x, hi.x, w.o[0], w.inv[0], l0, h0);
  slab_axis<kChecked>(lo.y, hi.y, w.o[1], w.inv[1], l1, h1);
  slab_axis<kChecked>(lo.z, hi.z, w.o[2], w.inv[2], l2, h2);
  t0 = fmaxf(fmaxf(l0, l1), l2);
  const float t1 = fminf(fminf(h0, h1), h2);
  return t0 <= t1;
}

__device__ __forceinline__ bool slab(float4 lo, float4 hi, const Walker& w, float& t0) {
  return slab_of<true>(lo, hi, w, t0);
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


// The outputs of each walk, and what it writes for a lane it does not
// walk (off the mask) or whose walk found no slot.
struct RayPtrs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
};

struct ClosestArgs {
  RayPtrs r;
  const int32_t* live;  // may be null: every lane
  float* t;
  int32_t* type;
  int32_t* index;
};

// BVH_ANY's lanes: the closest rays and their hits, from which each lane
// derives its shadow ray (Any::ray).
struct AnyArgs {
  RayPtrs r;            // the closest rays
  const float* t;       // the closest hit's t
  const int32_t* type;  // the closest hit's type (-1: a miss)
  const int32_t* in_path;
  const float *nx, *ny, *nz;  // the NEE direction
  int32_t* occ;
};

// BVH_CLOSEST's type of a lane whose walk found no slot, until the
// fallback pass sweeps it.
constexpr int32_t kPendingSweep = -2;

struct Closest {
  static constexpr bool kPrune = true;  // best-t pruning, entry times on the stack
  ClosestArgs a;
  const int32_t* __restrict__ prim_type;
  const int32_t* __restrict__ prim_index;
  const float* __restrict__ small;  // the fallback's sphere and plane rows
  int n_sph, rows_sph, rows_pln;
  unsigned long long* fallback_lanes;  // the fallback's lane count is added here (may be null)

  // lane i's ray, false off the mask
  __device__ bool ray(int i, Ray& out) const {
    if (a.live != nullptr && a.live[i] == 0) return false;
    const RayPtrs& r = a.r;
    out = Ray{r.ox[i], r.oy[i], r.oz[i], r.dx[i], r.dy[i], r.dz[i]};
    return true;
  }
  __device__ void off(int i) const {
    a.t[i] = INF;
    a.type[i] = -1;
    a.index[i] = 0;
  }
  // the walk's winner; a lane without one waits for the fallback pass
  __device__ void finish(int i, const Walker&, int slot, float best_t) const {
    if (slot >= 0) {
      a.t[i] = best_t;
      a.type[i] = __ldg(prim_type + slot);
      a.index[i] = __ldg(prim_index + slot);
    } else {
      a.type[i] = kPendingSweep;
    }
  }
};

// -- BVH_CLOSEST's fallback pass --------------------------------------------

// A tile: kTileSteps x kSweepThreads lanes in lane order, dealt from a
// counter. The block's pending lanes wait in a ring of kRing entries in
// shared memory: fewer than kSweepThreads carried over, plus a tile.
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kTileSteps = 4;
constexpr int kTile = kTileSteps * kSweepThreads;
constexpr int kRing = 2048;
static_assert(kRing >= kSweepThreads - 1 + kTile && (kRing & (kRing - 1)) == 0, "the ring");

// A row of the fallback as 16-byte words (SPH_COLS, PLN_COLS): a sphere's
// (pos c2) and (radius material valid -), a plane's four. Staged, a sphere
// row is its first word alone, with c2 = +inf where the row is not valid.
constexpr int kSphWords = SPH_COLS / 4;
constexpr int kPlnWords = PLN_COLS / 4;

// The pass's static shared memory (16-byte multiple, so the staged rows
// that follow it start aligned).
struct FallbackShared {
  int ring[kRing];                        // pending lanes, [head, tail) mod kRing
  int counts[kTileSteps * kSweepWarps];   // a tile's pending lanes by (step, warp)
  int next;                               // the block's next tile
  int pad[3];
};
static_assert(sizeof(FallbackShared) % 16 == 0, "FallbackShared");

// The most row bytes a block stages: the H100's opt-in 232,448 bytes less
// the static part (scene/device.py: FALLBACK_MAX_SHARED mirrors it;
// rt_bvh_fallback_max_rows_bytes asks the card). Past it the rows are read
// from global memory: over 14,000 sphere rows.
constexpr size_t kFallbackMaxRowsBytes = 232448 - sizeof(FallbackShared);

// The bytes of the staged rows: one word a sphere, four a plane.
inline size_t fallback_rows_bytes(int rows_sph, int rows_pln) {
  return sizeof(float4) * ((size_t)rows_sph + (size_t)kPlnWords * rows_pln);
}

inline bool fallback_staged(int rows_sph, int rows_pln) {
  return fallback_rows_bytes(rows_sph, rows_pln) <= kFallbackMaxRowsBytes;
}

// Word w of the rows: staged in shared memory, or through the read-only
// cache where they lie in global memory.
template <bool kStaged>
__device__ __forceinline__ float4 word(const float4* rows, int w) {
  return kStaged ? rows[w] : __ldg(rows + w);
}

// wavefront_common.cuh:sweep's sphere and plane loops for one ray
// (any_only false), expression for expression and in its order (sphere
// rows, then plane rows, index order, strict <, the same pre-tests), over
// rows of 16-byte words: a sphere reads its (pos c2) word and, unstaged,
// its valid flag; a plane its four words. Built with -fmad=false, so t,
// type and index are bitwise sweep's and ops/bvh.closest_plain's.
//
// A staged sphere row that is not valid has c2 = +inf in place of the
// flag: c is then +inf or NaN, 4 a_q c +inf or NaN (a_q >= 0 or NaN), and
// disc -inf or NaN, so the pre-test fails as the flag's test would.
template <bool kStaged>
__device__ __forceinline__ void sweep_words(const float4* sph, const float4* pln, int n_sph,
                                            int n_pln, const Ray& r, float& best_t,
                                            int& best_type, int& best_idx) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const float a_q = dx * dx + dy * dy + dz * dz;
  const float d_dot_o = dx * ox + dy * oy + dz * oz;
  const float o_dot_o = ox * ox + oy * oy + oz * oz;
  best_t = INF;
  best_type = -1;
  best_idx = 0;
  for (int i = 0; i < n_sph; ++i) {
    const float4 p = word<kStaged>(sph, kStaged ? i : kSphWords * i);  // cx cy cz c2
    const bool valid =
        kStaged || __ldg(reinterpret_cast<const float*>(sph + kSphWords * i) + 6) > 0.0f;
    float b = 2.0f * (d_dot_o - (dx * p.x + dy * p.y + dz * p.z));
    float c = o_dot_o - 2.0f * (ox * p.x + oy * p.y + oz * p.z) + p.w;
    float disc = b * b - 4.0f * a_q * c;
    if (!((disc >= 0.0f) && valid)) continue;
    float sq = sqrtf(maxn(disc, 0.0f));
    float q = b > 0.0f ? -0.5f * (b + sq) : -0.5f * (b - sq);
    float t0 = q / a_q;
    float t1 = c / (q == 0.0f ? 1.0f : q);
    float t = t0 < SPHERE_EPS ? t1 : (t1 < SPHERE_EPS ? t0 : minn(t0, t1));
    if (disc == 0.0f) t = -0.5f * b / a_q;
    if (t >= SPHERE_EPS && t < best_t) {
      best_t = t;
      best_type = 0;
      best_idx = i;
    }
  }
  for (int i = 0; i < n_pln; ++i) {
    // p[0..3] n ndotp, p[4..7] r0 r2.x, p[8..11] r2.yz r0dotp r2dotp, p[12..13] material valid
    const float4 w0 = word<kStaged>(pln, kPlnWords * i), w1 = word<kStaged>(pln, kPlnWords * i + 1);
    const float4 w2 = word<kStaged>(pln, kPlnWords * i + 2), w3 = word<kStaged>(pln, kPlnWords * i + 3);
    const float nx = w0.x, ny = w0.y, nz = w0.z;
    float denom = dx * nx + dy * ny + dz * nz;
    float num = w0.w - (ox * nx + oy * ny + oz * nz);
    if (!((fabsf(denom) >= PLANE_DENOM_EPS) && (denom > 0.0f ? num > 0.0f : num < 0.0f) &&
          (w3.y > 0.0f)))
      continue;
    float t = num / denom;
    float px = (ox * w1.x + oy * w1.y + oz * w1.z) + t * (dx * w1.x + dy * w1.y + dz * w1.z) - w2.z;
    float pz = (ox * w1.w + oy * w2.x + oz * w2.y) + t * (dx * w1.w + dy * w2.x + dz * w2.y) - w2.w;
    bool hit = (t >= PLANE_T_EPS) && (px >= 0.0f) && (px <= 1.0f) && (pz >= 0.0f) && (pz <= 1.0f);
    if (hit && t < best_t) {
      best_t = t;
      best_type = 1;
      best_idx = i;
    }
  }
}

// BVH_CLOSEST's fallback pass (see the header): persistent blocks that
// stage the valid rows once, take tiles of lanes from *deal, pack each
// tile's pending lanes into the ring (a ballot a warp and a prefix over
// the tile's (step, warp) counts), and sweep the ring a full block at a
// time, then once for the rest. Lanes that are not pending are read no
// further than their type.
template <bool kStaged>
__global__ void __launch_bounds__(kSweepThreads) fallback_kernel(Closest k, int* __restrict__ deal,
                                                                int n) {
  extern __shared__ float4 staged[];
  __shared__ FallbackShared sh;
  const int warp = threadIdx.x >> 5, me = threadIdx.x & 31;
  const float4* rows_sph = reinterpret_cast<const float4*>(k.small);
  const float4* rows_pln = rows_sph + kSphWords * k.n_sph;
  if (kStaged) {
    const int words = k.rows_sph + kPlnWords * k.rows_pln;
    for (int w = threadIdx.x; w < words; w += kSweepThreads) {
      const bool is_sph = w < k.rows_sph;
      float4 v = __ldg(is_sph ? rows_sph + kSphWords * w : rows_pln + (w - k.rows_sph));
      if (is_sph && !(__ldg(reinterpret_cast<const float*>(rows_sph + kSphWords * w) + 6) > 0.0f))
        v.w = INFINITY;
      staged[w] = v;
    }
    __syncthreads();
  }
  const float4* sph = kStaged ? staged : rows_sph;
  const float4* pln = kStaged ? staged + k.rows_sph : rows_pln;
  const RayPtrs& r = k.a.r;
  auto sweep_lane = [&](int i) {
    float t;
    int type, idx;
    sweep_words<kStaged>(sph, pln, k.rows_sph, k.rows_pln,
                         Ray{r.ox[i], r.oy[i], r.oz[i], r.dx[i], r.dy[i], r.dz[i]}, t, type, idx);
    k.a.t[i] = t;
    k.a.type[i] = type;
    k.a.index[i] = idx;
  };

  unsigned head = 0, tail = 0;  // the ring's pending lanes (the same in every thread)
  unsigned found = 0;
  for (int base = blockIdx.x * kTile; base < n;) {
    bool pending[kTileSteps];
    unsigned ballot[kTileSteps];
#pragma unroll
    for (int s = 0; s < kTileSteps; ++s) {
      const int i = base + s * kSweepThreads + threadIdx.x;
      pending[s] = i < n && k.a.type[i] == kPendingSweep;
    }
#pragma unroll
    for (int s = 0; s < kTileSteps; ++s) {
      ballot[s] = __ballot_sync(kFull, pending[s]);
      if (me == 0) sh.counts[s * kSweepWarps + warp] = __popc(ballot[s]);
    }
    if (threadIdx.x == 0) sh.next = gridDim.x * kTile + atomicAdd(deal, kTile);
    __syncthreads();
    unsigned before[kTileSteps], total = 0;
#pragma unroll
    for (int c = 0; c < kTileSteps * kSweepWarps; ++c) {
      if (c % kSweepWarps == warp) before[c / kSweepWarps] = total;
      total += sh.counts[c];
    }
    const unsigned below = (1u << me) - 1u;
#pragma unroll
    for (int s = 0; s < kTileSteps; ++s)
      if (pending[s])
        sh.ring[(tail + before[s] + __popc(ballot[s] & below)) & (kRing - 1)] =
            base + s * kSweepThreads + threadIdx.x;
    tail += total;
    found += total;
    base = sh.next;
    __syncthreads();
    for (; tail - head >= kSweepThreads; head += kSweepThreads)
      sweep_lane(sh.ring[(head + threadIdx.x) & (kRing - 1)]);
  }
  if (threadIdx.x < tail - head) sweep_lane(sh.ring[(head + threadIdx.x) & (kRing - 1)]);
  if (k.fallback_lanes != nullptr && threadIdx.x == 0 && found != 0)
    atomicAdd(k.fallback_lanes, (unsigned long long)found);
}

// As many blocks as the SMs hold at the pass's occupancy with `smem`
// bytes of rows (found again when the bytes change), or fewer for a small
// launch.
template <bool kStaged>
cudaError_t launch_fallback(const Closest& k, int* deal, int n, size_t smem, cudaStream_t stream) {
  static int resident[kMaxDevices];
  static size_t sized[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0 || sized[dev] != smem) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(fallback_kernel<kStaged>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
            cudaSuccess)
      return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fallback_kernel<kStaged>,
                                                             kSweepThreads, smem)) != cudaSuccess)
      return err;
    resident[dev] = std::max(1, sms * per_sm);
    sized[dev] = smem;
  }
  const int grid = std::min((n + kTile - 1) / kTile, resident[dev]);
  fallback_kernel<kStaged><<<grid, kSweepThreads, smem, stream>>>(k, deal, n);
  return cudaGetLastError();
}

// deal: one int32 of scratch at 0, the pass's tile counter.
cudaError_t fallback(const Closest& k, int* deal, int n, cudaStream_t stream) {
  if (fallback_staged(k.rows_sph, k.rows_pln))
    return launch_fallback<true>(k, deal, n, fallback_rows_bytes(k.rows_sph, k.rows_pln), stream);
  return launch_fallback<false>(k, deal, n, 0, stream);
}

struct Any {
  static constexpr bool kPrune = false;  // stops at the first hit
  AnyArgs a;

  // lane i's shadow ray, false unless the lane is in a path and its closest
  // ray hit: from the hit point ro + rd * t (a multiply, then an add, as
  // the plain twin rounds it) along the NEE direction
  __device__ bool ray(int i, Ray& out) const {
    if (a.type[i] < 0 || a.in_path[i] == 0) return false;
    const RayPtrs& r = a.r;
    const float t = a.t[i];
    out = Ray{r.ox[i] + r.dx[i] * t, r.oy[i] + r.dy[i] * t, r.oz[i] + r.dz[i] * t,
              a.nx[i], a.ny[i], a.nz[i]};
    return true;
  }
  __device__ void off(int i) const { a.occ[i] = 0; }
  __device__ void finish(int i, const Walker&, int slot, float) const {
    a.occ[i] = slot >= 0 ? 1 : 0;
  }
};

cudaError_t fallback(const Any&, int*, int, cudaStream_t) { return cudaSuccess; }

// Lane i before its walk: off the mask it gets the miss record (or 0); a
// ray that misses the root's box gets its finish at once (BVH_CLOSEST:
// pending the fallback pass). Returns whether lane i is walked, with its
// walker.
template <class K>
__device__ __forceinline__ bool start(const K& k, const Tree& tree, int i, Walker& w) {
  Ray r;
  if (!k.ray(i, r)) {
    k.off(i);
    return false;
  }
  w = walker(r);
  float entry;
  if (!slab(__ldg(tree.nodes), __ldg(tree.nodes + 1), w, entry)) {
    k.finish(i, w, -1, INF);
    return false;
  }
  return true;
}

// The walk. Each thread walks one lane at a time, as the reference's
// traverse_closest / traverse_any walk it: an interior node's row holds
// both children's boxes; the near child (by the sign of 1/rd on the
// split axis) first, the far one pushed with its entry time when both
// are entered (BVH_CLOSEST: entered before the best t); a popped node
// whose entry is past the best t is skipped; a leaf's slots in slot
// order, a strict < winner (BVH_ANY: the first hit ends the walk). A
// warp runs interior nodes until each of its lanes wants a leaf or is
// done, then tests the leaves, and takes the next lanes from *fetch
// whenever kRefill or more of its lanes are idle.
template <class K>
__global__ void __launch_bounds__(kThreads) walk_kernel(K k, Tree tree, int* __restrict__ fetch,
                                                        int n) {
  int stack_ref[kMaxStack];
  float stack_time[K::kPrune ? kMaxStack : 1];
  const int me = threadIdx.x & 31;
  int lane = -1;  // the lane this thread walks; -1: none
  Walker w;
  int cur = 0, sp = 0, best_slot = -1;
  float cur_entry = 0.0f, best_t = INF;

  auto take = [&](int i) {
    lane = -1;
    if (i >= n || !start(k, tree, i, w)) return;
    lane = i;
    cur = tree.root;
    cur_entry = 0.0f;
    best_t = INF;
    best_slot = -1;
    sp = 0;
  };
  // the next node off the stack (BVH_CLOSEST: skipping those entered past
  // the best t); false when the stack is empty
  auto pop = [&]() {
    while (sp > 0) {
      --sp;
      const int at = min(sp, kMaxStack - 1);
      cur = stack_ref[at];
      cur_entry = K::kPrune ? stack_time[at] : 0.0f;
      if (!K::kPrune || cur_entry <= best_t) return true;
    }
    return false;
  };
  auto done = [&](int slot) {
    k.finish(lane, w, slot, best_t);
    lane = -1;
  };

  // one interior node: both children's boxes from its row
  auto interior = [&]() {
    const float4* row = tree.pairs + 4 * cur;
    const float4 l_lo = __ldg(row), l_hi = __ldg(row + 1);
    const float4 r_lo = __ldg(row + 2), r_hi = __ldg(row + 3);
    const int axis = __float_as_int(r_lo.w);
    const float inv_axis = axis == 0 ? w.inv[0] : (axis == 1 ? w.inv[1] : w.inv[2]);
    const bool neg = inv_axis < 0.0f;
    float l_entry, r_entry;
    bool l_hit, r_hit;
    if (w.finite) {
      l_hit = slab_of<false>(l_lo, l_hi, w, l_entry);
      r_hit = slab_of<false>(r_lo, r_hi, w, r_entry);
    } else {
      l_hit = slab_of<true>(l_lo, l_hi, w, l_entry);
      r_hit = slab_of<true>(r_lo, r_hi, w, r_entry);
    }
    const int l_ref = __float_as_int(l_lo.w), r_ref = __float_as_int(l_hi.w);
    const int near = neg ? r_ref : l_ref, far = neg ? l_ref : r_ref;
    const float n_entry = neg ? r_entry : l_entry, f_entry = neg ? l_entry : r_entry;
    bool hit_n = neg ? r_hit : l_hit, hit_f = neg ? l_hit : r_hit;
    if (K::kPrune) {
      hit_n = hit_n && n_entry <= best_t;
      hit_f = hit_f && f_entry <= best_t;
    }
    if (hit_n && hit_f) {
      const int at = min(sp, kMaxStack - 1);
      stack_ref[at] = far;
      if (K::kPrune) stack_time[at] = f_entry;
      ++sp;
    }
    if (hit_n || hit_f) {
      cur = hit_n ? near : far;
      cur_entry = hit_n ? n_entry : f_entry;
    } else if (!pop()) {
      done(best_slot);
    }
  };
  // one leaf: its slots in order
  auto leaf = [&]() {
    const int packed = ~cur;
    const int first = packed >> 3, count = packed & 7;
    int hit = -1;
    for (int j = 0; j < count; ++j) {
      const float t = leaf_t(tree, first + j, w);
      if (t < best_t) {
        best_t = t;
        best_slot = first + j;
        if (!K::kPrune) {
          hit = best_slot;
          break;
        }
      }
    }
    if (hit >= 0) {
      done(hit);
    } else if (!pop()) {
      done(best_slot);
    }
  };

  bool drained = false;
  while (true) {
    if (!drained) {
      const unsigned idle = __ballot_sync(kFull, lane < 0);
      const int m = __popc(idle);
      if (m >= kRefill) {
        int first = 0;
        if (me == 0) first = atomicAdd(fetch, m);
        first = __shfl_sync(kFull, first, 0);
        if (lane < 0) take(first + __popc(idle & ((1u << me) - 1u)));
        drained = first + m >= n;
      }
    }
    if (__ballot_sync(kFull, lane >= 0) == 0) {
      if (drained) break;
      continue;
    }
    while (lane >= 0 && cur >= 0) interior();
    if (lane >= 0) leaf();
  }
}

// As many blocks as the SMs hold (found once a kernel and device), or
// fewer for a small launch.
template <class K>
cudaError_t launch_walk(const K& k, const Tree& tree, int* fetch, int n, cudaStream_t stream) {
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_kernel<K>, kThreads,
                                                             0)) != cudaSuccess)
      return err;
    resident[dev] = std::max(1, sms * per_sm);
  }
  const int grid = std::min((n + kThreads - 1) / kThreads, resident[dev]);
  walk_kernel<K><<<grid, kThreads, 0, stream>>>(k, tree, fetch, n);
  return cudaGetLastError();
}

// fetch: two int32 of scratch, the walk's lane counter and the fallback
// pass's tile counter.
template <class K>
int launch(const K& k, const Tree& tree, int depth, int* fetch, int n, cudaStream_t stream) {
  if (depth > kMaxStack) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(fetch, 0, 2 * sizeof(int), stream);
  if (err == cudaSuccess) err = launch_walk(k, tree, fetch, n, stream);
  if (err == cudaSuccess) err = fallback(k, fetch + 1, n, stream);
  return (int)err;
}

Tree tree_of(const float* nodes, const float* pairs, const float* prims, int root) {
  return Tree{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(pairs),
              reinterpret_cast<const float4*>(prims), root};
}

}  // namespace

extern "C" {

// p: 10 device pointers, ClosestArgs field order (6 f32 ray inputs, the
// i32 live mask or null, t f32, type i32, index i32). nodes (K, 12),
// pairs (I, 16) and prims (R, 16) f32, prim_type and prim_index (R,) i32,
// small the sphere and plane rows of the miss fallback (n_sph sphere rows,
// then the planes); the fallback sweeps the first rows_sph spheres and
// rows_pln planes (the valid ones: DeviceScene.sweep_rows). root: the
// root's reference; depth: the tree's (at most 64, the stack's entries);
// fetch: two int32 of device scratch; fallback_lanes: an int64 on the
// device that the fallback pass adds its lane count to, or null.
int rt_bvh_closest_launch(void** p, const float* nodes, const float* pairs, const float* prims,
                          const int32_t* prim_type, const int32_t* prim_index, const float* small,
                          int n_sph, int rows_sph, int rows_pln, int root, int depth, int* fetch,
                          int64_t* fallback_lanes, int n, void* stream) {
  static_assert(sizeof(ClosestArgs) == 10 * sizeof(void*), "ClosestArgs layout");
  Closest k;
  memcpy(&k.a, p, sizeof(k.a));
  k.prim_type = prim_type;
  k.prim_index = prim_index;
  k.small = small;
  k.n_sph = n_sph;
  k.rows_sph = rows_sph;
  k.rows_pln = rows_pln;
  k.fallback_lanes = reinterpret_cast<unsigned long long*>(fallback_lanes);
  return launch(k, tree_of(nodes, pairs, prims, root), depth, fetch, n, (cudaStream_t)stream);
}

// p: 13 device pointers, AnyArgs field order (the 6 f32 closest rays, t
// f32, type i32, in_path i32, the 3 f32 NEE direction components, occ
// i32); the rest as for BVH_CLOSEST (fetch: two int32).
int rt_bvh_any_launch(void** p, const float* nodes, const float* pairs, const float* prims,
                      int root, int depth, int* fetch, int n, void* stream) {
  static_assert(sizeof(AnyArgs) == 13 * sizeof(void*), "AnyArgs layout");
  Any k;
  memcpy(&k.a, p, sizeof(k.a));
  return launch(k, tree_of(nodes, pairs, prims, root), depth, fetch, n, (cudaStream_t)stream);
}

// The dynamic shared memory BVH_CLOSEST's fallback pass asks for with
// rows_sph sphere and rows_pln plane rows: the rows' bytes where they are
// staged, else 0 (read from global memory).
int rt_bvh_fallback_shared_bytes(int rows_sph, int rows_pln) {
  return fallback_staged(rows_sph, rows_pln) ? (int)fallback_rows_bytes(rows_sph, rows_pln) : 0;
}

// The most row bytes the pass can stage on the current card: its opt-in
// limit less the staged kernel's static shared memory (what
// kFallbackMaxRowsBytes assumes); -1 where the card cannot be asked.
int rt_bvh_fallback_max_rows_bytes() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, (const void*)fallback_kernel<true>) != cudaSuccess)
    return -1;
  return optin - (int)attr.sharedSizeBytes;
}

}  // extern "C"
