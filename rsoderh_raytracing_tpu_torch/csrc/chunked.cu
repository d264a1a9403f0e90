// CHUNKED_CLOSEST and CHUNKED_ANY: the big-mesh route's closest-hit and
// NEE occlusion sweeps.
//
// They replace the Pallas kernels rsoderh_raytracing_tpu/ops/
// pallas_intersect.py:_chunked_closest_kernel and _chunked_any_kernel
// (via _chunked_tiles_call, pallas_call at :1518/:1524). The scene's
// triangles (and, when they do not fit the unrolled step, its spheres) are
// cut into chunks of 64 rows of 20 floats, each behind an AABB
// (scene/device.py builds the tables and holds them). Per lane:
//
// 1. the unrolled step: planes, and spheres when they are not chunked,
//    with the small-scene sweep of wavefront_common.cuh;
// 2. every chunk whose AABB the ray passes (chunk_slab_mask,
//    pallas_intersect.py:435), for lanes with live != 0 (closest) or
//    mask != 0 and not yet occluded (occlusion); the other lanes keep the
//    unrolled step's result, which the wavefront never reads.
//
// What bounds them on the H100 is the instruction rate, f32 outside the
// tensor cores and unfused (-fmad=false), so that every hit decision
// equals the plain version's: a slab test for every (lane, chunk) and 64
// primitive tests for every pair that passes. A lane passes only a few of
// the chunks (3.5 of 242 on suzanne_hi), and after the first bounce the
// lanes of a warp pass different ones. With one thread a lane the time
// goes into the NaN-propagating slab tests of chunks the lane then skips
// (some 110 instructions each), and most of a warp idles through every
// window loop. So the unit of work here is the pair, and a block walks
// the chunks together:
//
// - A block owns a tile of kTile lanes. Each thread runs the unrolled step
//   for its kLanes lanes and leaves in shared memory the lane's 12 ray
//   terms, its 1/d, and its running winner as one 64-bit key,
//   float_as_uint(t) << 32 | kind << 28 | index. Every hit has t > 0, so
//   the unsigned order of the key is the order of t, then sphere (0) <
//   plane (1) < triangle (2), then the lowest index: the dense sweep's
//   strict-< winner, whatever the order the pairs are processed in. A miss
//   is the key of t = INF. CHUNKED_ANY keeps an occluded flag instead.
// - Batches of kBatch chunks. The batch's windows start towards shared
//   memory by cp.async. Meanwhile each thread tests its lanes' rays
//   against the union of the batch's boxes (CHUNKED_CLOSEST bounded by the
//   t of the lane's key at the batch's start, t0 <= t*(1+1e-3)+1e-4); a
//   lane that passes is a candidate (15% of the lanes on suzanne_hi), one
//   atomicAdd a warp (__ballot_sync + __popc).
// - Every (candidate, chunk of the batch) is then one slab test of one
//   thread, so no thread idles on a lane that missed the union box; a
//   passing (lane, chunk) pair joins its chunk's queue. A ray whose slab
//   products cannot be NaN (finite origin, finite nonzero 1/d) takes the
//   hardware's min/max, 28 instructions a test; the others the
//   NaN-propagating form.
// - The sweep. The batch's pairs, chunk after chunk, are dealt to the
//   warps in equal contiguous shares. For each chunk its share touches,
//   thread j takes rows j and j + 32 of the window into registers once,
//   then for each queued lane reads the ray terms (three 16-byte shared-memory broadcasts),
//   tests its two rows and, only if one is hit, does atomicMin on the
//   lane's key (or sets its flag; a lane found occluded meanwhile is
//   dropped). Every thread does useful tests for every pair; hits are
//   rare, so the atomics are too.
//
// Every cull is conservative. A box that holds a primitive with t <= best
// has a slab entry t0 <= t, so it passes whatever older, larger best the
// slab test saw, and the union of boxes contains each box (a NaN bound
// propagates into the union, and a NaN slab term imposes no constraint);
// a pair queued against a stale best costs time, never a result. OR does
// not depend on order. So the outputs equal the plain version's on every
// lane, t bit for bit. A NaN t is no hit.
//
// Shared memory of a block (kTile 1,024, kBatch 16): windows kBatch x
// 5,120 B = 80 KB, ray terms kTile x 64 B = 64 KB, keys 8 KB, queues
// kBatch x kTile x 2 B = 32 KB (a lane enters a chunk's queue at most once,
// so they cannot overflow), candidates 2 KB, the batch's bounds and two
// sets of counts under 1 KB: OFF_SMALL = 191,136 B, then the unrolled
// primitives (small_len floats rounded up to a quad, at most 12 KB) and
// 32 B a batch for the union boxes (the bounds table itself is staged a
// batch at a time): 192,416 B on suzanne_hi (242 chunks; its 8 sphere and
// 8 plane lanes unrolled, 768 B), 222,880 B on suzanne_xxhi (15,488
// chunks) of the MAX_SHARED = 232,448 B (227 KB) a block may ask for. So
// the block's shared memory, not a count, limits a scene's chunks: 20,272
// with suzanne's unrolled rows.
// scene/device.py mirrors shared_bytes (chunked_shared_bytes) and keeps a
// scene past the limit off the launchers, which refuse it too
// (cudaErrorInvalidValue). One block of 512 threads a multiprocessor, at most
// 128 registers a thread. Every block streams every window from L2:
// lanes / kTile x the window table a launch (5 GB on suzanne_hi at 4.2M
// lanes).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "wavefront_common.cuh"

using namespace rt;

namespace {

constexpr int CHUNK = 64;
constexpr int WIN_COLS = 20;
constexpr int WIN_FLOATS = CHUNK * WIN_COLS;
constexpr int BOUND_COLS = 8;  // six bounds in shared memory, padded to two quads
constexpr int TERM_COLS = 16;  // a lane's RayTerms (12), 1/d (3), padding: four quads
// The tile's shape: threads a block, lanes a thread, chunks a batch.
constexpr int kThreads = 512;
constexpr int kLanes = 2;
constexpr int kTile = kThreads * kLanes;
constexpr int kBatch = 16;
constexpr int kWarps = kThreads / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
// A set of counts: kBatch chunk queues, then the candidates; padded to a quad.
constexpr int COUNT_SLOTS = kBatch + 4;
constexpr unsigned NOT_FINITE = 0x8000u;  // candidate entry: lane | NOT_FINITE
static_assert(kBatch <= 32, "a warp scans the batch's counts in one step");
static_assert(kTile <= 32768, "queue entries are 15-bit lane numbers");
static_assert(kThreads % 32 == 0 && kThreads >= 2 * COUNT_SLOTS, "whole warps; a thread a count");

typedef unsigned long long Key;

struct ChunkArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int32_t* lane_mask;  // live (closest) or hit mask (occlusion)
};

struct ChunkScene {
  const float* small;   // packed sphere rows (unless chunked) then plane rows
  int small_len, n_sph, n_pln;
  const float* bounds;  // (C, 6) [min xyz, max xyz]
  const float* win;     // (C * CHUNK, WIN_COLS), 16-byte aligned
  int n_tri_chunks, n_chunks;
};

// Byte offsets of a block's dynamic shared memory; after OFF_SMALL the
// unrolled primitives (small_len floats, rounded up to a quad), then the
// batches' union bounds (BOUND_COLS floats a batch).
constexpr size_t OFF_WIN = 0;
constexpr size_t OFF_KEYS = OFF_WIN + (size_t)kBatch * WIN_FLOATS * 4;
constexpr size_t OFF_TERMS = OFF_KEYS + (size_t)kTile * 8;
constexpr size_t OFF_QUEUE = OFF_TERMS + (size_t)kTile * TERM_COLS * 4;
constexpr size_t OFF_CAND = OFF_QUEUE + (size_t)kBatch * kTile * 2;
constexpr size_t OFF_BOUNDS = OFF_CAND + (size_t)kTile * 2;
constexpr size_t OFF_COUNTS = OFF_BOUNDS + (size_t)kBatch * BOUND_COLS * 4;
constexpr size_t OFF_SMALL = OFF_COUNTS + (size_t)2 * COUNT_SLOTS * 4;
constexpr size_t MAX_SHARED = 232448;  // 227 KB
static_assert(OFF_SMALL % 16 == 0 && OFF_BOUNDS % 16 == 0 && OFF_TERMS % 16 == 0, "quad alignment");

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int batch_count(int n_chunks) { return (n_chunks + kBatch - 1) / kBatch; }

__device__ __forceinline__ Key pack_key(float t, int kind, int idx) {
  return ((Key)__float_as_uint(t) << 32) | (Key)(((unsigned)kind << 28) | (unsigned)idx);
}
__device__ __forceinline__ Key miss_key() { return (Key)__float_as_uint(INF) << 32; }
__device__ __forceinline__ float key_t(Key k) { return __uint_as_float((unsigned)(k >> 32)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// chunk_slab_mask for one lane and one box; b: six bounds in two quads
// of shared memory. inv = 1/d may be +-inf; a 0 * inf NaN means the axis
// imposes no constraint, mapped to -INF/INF explicitly (minn/maxn
// propagate NaN like jnp.minimum/maximum). CHUNKED_CLOSEST (kBounded) also
// asks t0 <= bound, the lane's slab_bound.
template <bool kBounded>
__device__ __forceinline__ bool slab_pass(const float* b, const float* o, const float* inv,
                                          float bound) {
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float near = (b[a] - o[a]) * inv[a];
    const float far = (b[3 + a] - o[a]) * inv[a];
    const float t_lo = minn(near, far);
    const float t_hi = maxn(near, far);
    lo[a] = isnan_(t_lo) ? -INF : t_lo;
    hi[a] = isnan_(t_hi) ? INF : t_hi;
  }
  const float t0 = maxn(maxn(lo[0], lo[1]), maxn(lo[2], 0.0f));
  const float t1 = minn(minn(hi[0], hi[1]), hi[2]);
  bool hit = t0 <= t1;
  if (kBounded) hit = hit && (t0 <= bound);
  return hit;
}

// slab_pass for a lane of finite_axes(): a finite bound less a finite
// origin is finite or +-inf, and times a finite nonzero factor never NaN,
// so minn/maxn are the hardware's min/max, one instruction each where the
// NaN-propagating forms take six: the same values and the same decision
// at a third of the instructions. A NaN bound (a NaN vertex) is NaN on
// both sides of its axis (scene/device.py's pair_nan_bounds sees to it,
// and the union of boxes keeps it so), so both products of the axis are
// NaN; the hardware's min/max drop them, which is the axis without a
// constraint, as above (the +inf keeps t1 a number when every axis is
// dropped).
template <bool kBounded>
__device__ __forceinline__ bool slab_pass_finite(const float* b, const float* o, const float* inv,
                                                 float bound) {
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float near = (b[a] - o[a]) * inv[a];
    const float far = (b[3 + a] - o[a]) * inv[a];
    lo[a] = fminf(near, far);
    hi[a] = fmaxf(near, far);
  }
  const float t0 = fmaxf(fmaxf(lo[0], lo[1]), fmaxf(lo[2], 0.0f));
  const float t1 = fminf(fminf(hi[0], hi[1]), fminf(hi[2], __int_as_float(0x7f800000)));
  bool hit = t0 <= t1;
  if (kBounded) hit = hit && (t0 <= bound);
  return hit;
}

// The slab test of one ray (origin o, 1/d inv) against the box in the two
// quads at b2.
template <bool kBounded>
__device__ __forceinline__ bool box_pass(const float4* b2, const float* o, const float* inv,
                                         bool finite, float bound) {
  const float4 b0 = b2[0], b1 = b2[1];
  const float b[6] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y};
  return finite ? slab_pass_finite<kBounded>(b, o, inv, bound) : slab_pass<kBounded>(b, o, inv, bound);
}

__device__ __forceinline__ bool finite_(float x) { return fabsf(x) <= 3.402823466e+38f; }

// Whether no slab product of this ray can be NaN on finite bounds: origin
// finite, every 1/d finite and nonzero (no axis-parallel, denormal or
// infinite d).
__device__ __forceinline__ bool finite_axes(const Ray& r, const float* inv) {
  return finite_(r.ox) && finite_(r.oy) && finite_(r.oz) && finite_(inv[0]) && finite_(inv[1]) &&
         finite_(inv[2]) && inv[0] != 0.0f && inv[1] != 0.0f && inv[2] != 0.0f;
}

// The largest slab entry a box may have to matter to a lane whose running
// best is t_max.
__device__ __forceinline__ float slab_bound(float t_max) {
  return t_max * (float)(1.0 + 1e-3) + (float)1e-4;
}

__device__ __forceinline__ SceneView small_view(const float* smem, const ChunkScene& s) {
  SceneView v;
  v.sph = smem;
  v.pln = smem + s.n_sph * SPH_COLS;
  v.tri = nullptr;
  v.mat = nullptr;
  v.n_sph = s.n_sph;
  v.n_pln = s.n_pln;
  v.n_tri = 0;
  v.n_mat = 0;
  return v;
}

// A tile lane's ray terms in shared memory: TERM_COLS floats, ox oy oz dx |
// dy dz a_q d_dot_o | o_dot_o mx my mz | 1/dx 1/dy 1/dz -.
__device__ __forceinline__ void store_terms(float4* terms, int lane, const RayTerms& k,
                                            const float* inv) {
  float4* p = terms + lane * (TERM_COLS / 4);
  p[0] = make_float4(k.ox, k.oy, k.oz, k.dx);
  p[1] = make_float4(k.dy, k.dz, k.a_q, k.d_dot_o);
  p[2] = make_float4(k.o_dot_o, k.mx, k.my, k.mz);
  p[3] = make_float4(inv[0], inv[1], inv[2], 0.0f);
}

__device__ __forceinline__ RayTerms load_terms(const float4* terms, int lane) {
  const float4* p = terms + lane * (TERM_COLS / 4);
  const float4 a = p[0], b = p[1], c = p[2];
  RayTerms k;
  k.ox = a.x; k.oy = a.y; k.oz = a.z; k.dx = a.w;
  k.dy = b.x; k.dz = b.y; k.a_q = b.z; k.d_dot_o = b.w;
  k.o_dot_o = c.x; k.mx = c.y; k.my = c.z; k.mz = c.w;
  return k;
}

// Pairs [first, last) of one chunk's queue, by one warp: this thread's
// two rows (row and row + 32 of the window `w`) against each queued lane.
// `base`: the index of the window's first primitive among its kind.
template <bool kClosest, bool kTri>
__device__ __forceinline__ void sweep_pairs(const float4* w, int row, int base,
                                              const uint16_t* queue, int first, int last,
                                              const float4* terms, Key* keys,
                                              volatile unsigned* flags) {
  // a sphere row holds pos[3] c2 valid in its first two quads
  constexpr int kQuads = kTri ? WIN_COLS / 4 : 2;
  float ra[kQuads * 4], rb[kQuads * 4];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const float4 a = w[row * (WIN_COLS / 4) + q];
    const float4 b = w[(row + 32) * (WIN_COLS / 4) + q];
    ra[4 * q] = a.x; ra[4 * q + 1] = a.y; ra[4 * q + 2] = a.z; ra[4 * q + 3] = a.w;
    rb[4 * q] = b.x; rb[4 * q + 1] = b.y; rb[4 * q + 2] = b.z; rb[4 * q + 3] = b.w;
  }
  const int kind = kTri ? 2 : 0;
  for (int p = first; p < last; ++p) {
    const int lane = queue[p];
    if (!kClosest && flags[lane] != 0u) continue;  // occluded meanwhile
    const RayTerms k = load_terms(terms, lane);
    float ta = 0.0f, tb = 0.0f;
    bool ha, hb;
    if constexpr (kTri && kClosest) {
      ha = tri_hit<false>(k, ra, ta);
      hb = tri_hit<false>(k, rb, tb);
    } else if constexpr (kTri) {
      ha = tri_occluded<false>(k, ra);
      hb = tri_occluded<false>(k, rb);
    } else {
      ha = sphere_hit(k, ra[0], ra[1], ra[2], ra[3], ra[4] > 0.0f, ta);
      hb = sphere_hit(k, rb[0], rb[1], rb[2], rb[3], rb[4] > 0.0f, tb);
    }
    if (!(ha || hb)) continue;
    if (kClosest) {
      const Key ka = ha ? pack_key(ta, kind, base + row) : ~(Key)0;
      const Key kb = hb ? pack_key(tb, kind, base + row + 32) : ~(Key)0;
      const Key m = ka < kb ? ka : kb;
      if (m < *(volatile Key*)(keys + lane)) atomicMin(keys + lane, m);
    } else {
      flags[lane] = 1u;
    }
  }
}

// One block: a tile of kTile lanes against the whole scene. out_a/out_b/
// out_c: (t, type, index) for kClosest, else out_b is the occluded flag.
template <bool kClosest>
__device__ __forceinline__ void chunked_tile(const ChunkArgs& a, const ChunkScene& s, float* out_a,
                                             int32_t* out_b, int32_t* out_c, int n) {
  extern __shared__ __align__(16) unsigned char shared[];
  float4* swin = reinterpret_cast<float4*>(shared + OFF_WIN);
  Key* keys = reinterpret_cast<Key*>(shared + OFF_KEYS);
  // CHUNKED_ANY's per-lane state, in the keys' place
  unsigned* flags = reinterpret_cast<unsigned*>(shared + OFF_KEYS);
  float4* terms = reinterpret_cast<float4*>(shared + OFF_TERMS);
  uint16_t* queue = reinterpret_cast<uint16_t*>(shared + OFF_QUEUE);
  uint16_t* cand = reinterpret_cast<uint16_t*>(shared + OFF_CAND);
  float* sbounds = reinterpret_cast<float*>(shared + OFF_BOUNDS);
  int* all_counts = reinterpret_cast<int*>(shared + OFF_COUNTS);
  float* small = reinterpret_cast<float*>(shared + OFF_SMALL);
  float* sunion = small + round_up4(s.small_len);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane_id = tid & 31;
  const int tile_base = blockIdx.x * kTile;

  // the unrolled primitives; each batch's union box (NaN bounds propagate,
  // so such a batch is never culled); both sets of counts
  for (int k = tid; k < s.small_len; k += kThreads) small[k] = s.small[k];
  for (int k = tid; k < batch_count(s.n_chunks) * BOUND_COLS; k += kThreads) {
    const int c0 = k / BOUND_COLS * kBatch, col = k % BOUND_COLS;
    float v = 0.0f;
    if (col < 6) {
      // kBatch loads in flight at once; a chunk past the end repeats the last
      float x[kBatch];
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        x[c] = __ldg(s.bounds + (size_t)min(c0 + c, s.n_chunks - 1) * 6 + col);
      }
      v = x[0];
#pragma unroll
      for (int c = 1; c < kBatch; ++c) v = col < 3 ? minn(v, x[c]) : maxn(v, x[c]);
    }
    sunion[k] = v;
  }
  if (tid < 2 * COUNT_SLOTS) all_counts[tid] = 0;
  __syncthreads();

  // 1. the unrolled step, the lane's key (or flag) and ray terms
  Ray r[kLanes];
  float inv[kLanes][3];
  bool active[kLanes], finite[kLanes];
  const SceneView view = small_view(small, s);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const int lane = tid + l * kThreads;
    const int i = tile_base + lane;
    r[l] = Ray{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    inv[l][0] = inv[l][1] = inv[l][2] = 0.0f;
    active[l] = finite[l] = false;
    if (i < n) {
      r[l] = Ray{a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i]};
      float best_t;
      int best_type, best_idx;
      sweep(view, r[l], !kClosest, best_t, best_type, best_idx);
      if (kClosest) {
        keys[lane] = best_type >= 0 ? pack_key(best_t, best_type, best_idx) : miss_key();
        active[l] = a.lane_mask[i] != 0;
      } else {
        const bool occ = best_t < INF;
        flags[lane] = occ ? 1u : 0u;
        active[l] = !occ && a.lane_mask[i] != 0;
      }
      if (active[l]) {
        inv[l][0] = 1.0f / r[l].dx;
        inv[l][1] = 1.0f / r[l].dy;
        inv[l][2] = 1.0f / r[l].dz;
        finite[l] = finite_axes(r[l], inv[l]);
        store_terms(terms, lane, ray_terms(r[l]), inv[l]);
      }
    }
  }
  bool mine = false;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) mine = mine || active[l];
  // a tile without a live (masked) lane walks no chunk
  const int n_chunks = __syncthreads_or(mine) ? s.n_chunks : 0;

  for (int c0 = 0, batch = 0; c0 < n_chunks; c0 += kBatch, ++batch) {
    const int nb = min(kBatch, n_chunks - c0);
    // this batch's counts: [0, kBatch) the chunks' queues, [kBatch] the
    // candidates; zero since the sweep before last
    int* counts = all_counts + (batch & 1) * COUNT_SLOTS;

    // 2. the batch's windows start towards shared memory, and its bounds;
    // meanwhile each lane whose ray passes the batch's union box becomes a
    // candidate, one atomicAdd a warp
    for (int k = tid; k < kBatch * BOUND_COLS; k += kThreads) {
      const int c = k / BOUND_COLS, col = k % BOUND_COLS;
      sbounds[k] = (c < nb && col < 6) ? __ldg(s.bounds + (size_t)(c0 + c) * 6 + col) : 0.0f;
    }
    const float4* src = reinterpret_cast<const float4*>(s.win + (size_t)c0 * WIN_FLOATS);
    for (int k = tid; k < nb * (WIN_FLOATS / 4); k += kThreads) cp_async16(swin + k, src + k);
    cp_async_commit();
    const float4* box = reinterpret_cast<const float4*>(sunion) + batch * (BOUND_COLS / 4);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const int lane = tid + l * kThreads;
      float bound = 0.0f;
      if (kClosest) {
        if (active[l]) bound = slab_bound(key_t(keys[lane]));
      } else if (active[l] && ((volatile unsigned*)flags)[lane] != 0u) {
        active[l] = false;  // occluded by an earlier batch
      }
      const float o[3] = {r[l].ox, r[l].oy, r[l].oz};
      const bool pass = active[l] && box_pass<kClosest>(box, o, inv[l], finite[l], bound);
      const unsigned votes = __ballot_sync(FULL, pass);
      if (votes == 0u) continue;
      int at = 0;
      if (lane_id == 0) at = atomicAdd(counts + kBatch, __popc(votes));
      at = __shfl_sync(FULL, at, 0) + __popc(votes & ((1u << lane_id) - 1u));
      if (pass) cand[at] = (uint16_t)(lane | (finite[l] ? 0u : NOT_FINITE));
    }
    __syncthreads();

    // 3. every (candidate, chunk of the batch) is one slab test of one
    // thread; a passing (lane, chunk) pair joins its chunk's queue
    const int n_items = counts[kBatch] * kBatch;
    for (int item = tid; item < n_items; item += kThreads) {
      const int c = item % kBatch;
      if (c >= nb) continue;
      const unsigned entry = cand[item / kBatch];
      const int lane = entry & (NOT_FINITE - 1u);
      const float4 q0 = terms[lane * (TERM_COLS / 4)], q3 = terms[lane * (TERM_COLS / 4) + 3];
      const float o[3] = {q0.x, q0.y, q0.z};
      const float iv[3] = {q3.x, q3.y, q3.z};
      const float bound = kClosest ? slab_bound(key_t(keys[lane])) : 0.0f;
      const float4* b2 = reinterpret_cast<const float4*>(sbounds) + c * (BOUND_COLS / 4);
      if (box_pass<kClosest>(b2, o, iv, (entry & NOT_FINITE) == 0u, bound)) {
        queue[c * kTile + atomicAdd(counts + c, 1)] = (uint16_t)lane;
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // 4. the sweep: the batch's pairs, chunk after chunk, in equal
    // contiguous shares to the warps; the other set of counts is zeroed for
    // the next batch
    if (tid < COUNT_SLOTS) all_counts[((batch + 1) & 1) * COUNT_SLOTS + tid] = 0;
    const int cnt = lane_id < nb ? counts[lane_id] : 0;
    int upto = cnt;  // inclusive prefix sum over the batch's chunks
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, upto, d);
      if (lane_id >= d) upto += v;
    }
    const int share = (__shfl_sync(FULL, upto, 31) + kWarps - 1) / kWarps;
    int begin = warp * share;
    const int end = min(begin + share, __shfl_sync(FULL, upto, 31));
    while (begin < end) {
      const int c = __ffs(__ballot_sync(FULL, upto > begin)) - 1;
      const int chunk_end = __shfl_sync(FULL, upto, c);
      const int chunk_begin = chunk_end - __shfl_sync(FULL, cnt, c);
      const int first = begin - chunk_begin, last = min(end, chunk_end) - chunk_begin;
      const float4* w = swin + c * (WIN_FLOATS / 4);
      const uint16_t* q = queue + c * kTile;
      if (c0 + c < s.n_tri_chunks) {
        sweep_pairs<kClosest, true>(w, lane_id, (c0 + c) * CHUNK, q, first, last, terms, keys, flags);
      } else {
        sweep_pairs<kClosest, false>(w, lane_id, (c0 + c - s.n_tri_chunks) * CHUNK, q, first, last,
                                       terms, keys, flags);
      }
      begin = min(end, chunk_end);
    }
    __syncthreads();
  }

  // 5. write-out
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const int lane = tid + l * kThreads;
    const int i = tile_base + lane;
    if (i >= n) continue;
    if (kClosest) {
      const Key k = keys[lane];
      const bool hit = k < miss_key();
      const unsigned low = (unsigned)k;
      out_a[i] = hit ? key_t(k) : INF;
      out_b[i] = hit ? (int)(low >> 28) : -1;
      out_c[i] = hit ? (int)(low & 0x0FFFFFFFu) : 0;
    } else {
      out_b[i] = flags[lane] != 0u ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    chunked_closest_kernel(ChunkArgs a, ChunkScene s, float* out_t, int32_t* out_type,
                           int32_t* out_idx, int n) {
  chunked_tile<true>(a, s, out_t, out_type, out_idx, n);
}

__global__ void __launch_bounds__(kThreads, 1)
    chunked_any_kernel(ChunkArgs a, ChunkScene s, int32_t* out_occ, int n) {
  chunked_tile<false>(a, s, nullptr, out_occ, nullptr, n);
}

// Dynamic shared memory of a block, bytes.
size_t shared_bytes(int small_len, int n_chunks) {
  return OFF_SMALL + sizeof(float) * (round_up4(small_len) + (size_t)batch_count(n_chunks) * BOUND_COLS);
}

// Launch `kernel` over n lanes with the block's shared memory; the CUDA
// error code.
template <class Kernel, class... Out>
int launch(Kernel kernel, void** p, const ChunkScene& s, int n, void* stream, Out... out) {
  static_assert(sizeof(ChunkArgs) == 7 * sizeof(void*), "ChunkArgs layout");
  ChunkArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  const size_t shared = shared_bytes(s.small_len, s.n_chunks);
  if (shared > MAX_SHARED || s.n_tri_chunks > s.n_chunks) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(s.win) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(n + kTile - 1) / kTile, kThreads, shared, (cudaStream_t)stream>>>(a, s, out..., n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a block of either kernel asks for on such a scene, bytes.
int rt_chunked_shared_bytes(int small_len, int n_chunks) {
  return (int)shared_bytes(small_len, n_chunks);
}

// Chunks a batch: the traversal's one parameter that changes which (lane,
// chunk) pairs are swept (ops/intersect.chunked_*_model takes it).
int rt_chunked_batch() { return kBatch; }

// p: 7 device pointers, ChunkArgs field order (ray components, live mask).
int rt_chunked_closest_launch(void** p, const float* small, int small_len, int n_sph, int n_pln,
                              const float* bounds, const float* win, int n_tri_chunks,
                              int n_chunks, float* out_t, int32_t* out_type, int32_t* out_idx,
                              int n, void* stream) {
  const ChunkScene s{small, small_len, n_sph, n_pln, bounds, win, n_tri_chunks, n_chunks};
  return launch(chunked_closest_kernel, p, s, n, stream, out_t, out_type, out_idx);
}

// p: 7 device pointers, ChunkArgs field order (ray components, hit mask).
int rt_chunked_any_launch(void** p, const float* small, int small_len, int n_sph, int n_pln,
                          const float* bounds, const float* win, int n_tri_chunks, int n_chunks,
                          int32_t* out_occ, int n, void* stream) {
  const ChunkScene s{small, small_len, n_sph, n_pln, bounds, win, n_tri_chunks, n_chunks};
  return launch(chunked_any_kernel, p, s, n, stream, out_occ);
}

}  // extern "C"
