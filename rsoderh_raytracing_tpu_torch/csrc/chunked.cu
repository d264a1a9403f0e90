// CHUNKED_CLOSEST and CHUNKED_ANY: the big-mesh route's closest-hit and
// NEE occlusion sweeps.
//
// They replace the Pallas kernels rsoderh_raytracing_tpu/ops/
// pallas_intersect.py:_chunked_closest_kernel and _chunked_any_kernel
// (via _chunked_tiles_call, pallas_call at :1518/:1524). The scene's
// triangles (and, when they do not fit the unrolled step, its spheres) are
// cut into chunks of 64 rows of 20 floats (ops/cuda_intersect.py builds
// the tables; scene/device.py holds them). Per lane:
//
// 1. the unrolled step: planes, and spheres when they are not chunked,
//    with the small-scene sweep of wavefront_common.cuh;
// 2. every chunk in index order, triangle windows first, then sphere
//    windows, each behind the chunk-AABB slab test of chunk_slab_mask
//    (pallas_intersect.py:435). CHUNKED_CLOSEST bounds the slab entry by
//    the running best t (t0 <= t*(1+1e-3)+1e-4) and skips every chunk
//    for lanes with live == 0; triangles win on strict <, spheres on <
//    or on == over an incumbent of type > 0, which gives the dense
//    sphere -> plane -> triangle winner without a tie-break.
//    CHUNKED_ANY culls by the slab alone, skips lanes with mask == 0,
//    tests triangles division-free (tri_chunk_occluded) and spheres by
//    their divided test, and leaves the loop once the lane is occluded
//    (OR does not depend on order).
//
// The TPU decided the cull per (ray tile, chunk) grid step; here it is
// per lane. That is exact for every lane the caller consumes (live lanes
// for the closest hit, masked lanes for occlusion) because the cull is
// conservative: a skipped chunk holds no primitive that could change
// the lane's result. Dead and unmasked lanes keep the unrolled step's
// result, which may differ from the Pallas output; the wavefront never
// reads them. No shortlist, grouped windows or lane compaction: those
// were TPU grid-step machinery, bit-transparent by the reference's tests.
//
// Layout and bounds. One thread a lane, 256 a block. The unrolled
// primitives (at most 128 rows, 8 KB) are staged in shared memory. The
// bounds table (at most 8,192 chunks, 196 KB) and the windows are read
// from global memory with __ldg: suzanne_hi's windows are 1.2 MB and its
// bounds 5.8 KB, resident in the 50 MB L2, and in a warp every lane that
// passes the cull reads the same row, a broadcast. What bounds the
// kernels on the H100 is the arithmetic of the (lane, chunk) pairs that
// pass the cull, 64 primitive tests each, and warp divergence: lanes of a
// warp that disagree on the cull idle while the others sweep a window.
// A warp-vote cull or a coherent lane order is later work.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "wavefront_common.cuh"

using namespace rt;

namespace {

constexpr int CHUNK = 64;
constexpr int WIN_COLS = 20;
constexpr int kThreads = 256;

struct ChunkArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const int32_t* lane_mask;  // live (closest) or hit mask (occlusion)
};

struct ChunkScene {
  const float* small;   // packed sphere rows (unless chunked) then plane rows
  int small_len, n_sph, n_pln;
  const float* bounds;  // (C, 6) [min xyz, max xyz]
  const float* win;     // (C * CHUNK, WIN_COLS)
  int n_tri_chunks, n_chunks;
};

// chunk_slab_mask for one lane and one chunk. inv = 1/d may be +-inf; a
// 0 * inf NaN means the axis imposes no constraint, mapped to -INF/INF
// explicitly (minn/maxn propagate NaN like jnp.minimum/maximum).
__device__ __forceinline__ bool slab_pass(const float* b, const Ray& r, float ix, float iy,
                                          float iz, bool bounded, float t_max) {
  float lo[3], hi[3];
  const float o[3] = {r.ox, r.oy, r.oz};
  const float inv[3] = {ix, iy, iz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float near = (__ldg(b + a) - o[a]) * inv[a];
    const float far = (__ldg(b + 3 + a) - o[a]) * inv[a];
    const float t_lo = minn(near, far);
    const float t_hi = maxn(near, far);
    lo[a] = isnan_(t_lo) ? -INF : t_lo;
    hi[a] = isnan_(t_hi) ? INF : t_hi;
  }
  const float t0 = maxn(maxn(lo[0], lo[1]), maxn(lo[2], 0.0f));
  const float t1 = minn(minn(hi[0], hi[1]), hi[2]);
  bool hit = t0 <= t1;
  if (bounded) hit = hit && (t0 <= t_max * (float)(1.0 + 1e-3) + (float)1e-4);
  return hit;
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

__global__ void chunked_closest_kernel(ChunkArgs a, ChunkScene s, float* out_t, int32_t* out_type,
                                       int32_t* out_idx, int n) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < s.small_len; k += blockDim.x) smem[k] = s.small[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const Ray r{a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i]};
  float best_t;
  int best_type, best_idx;
  sweep(small_view(smem, s), r, false, best_t, best_type, best_idx);

  if (a.lane_mask[i] != 0) {
    const RayTerms k = ray_terms(r);
    const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
    float t;
    for (int c = 0; c < s.n_chunks; ++c) {
      if (!slab_pass(s.bounds + 6 * c, r, ix, iy, iz, true, best_t)) continue;
      const float* w = s.win + (size_t)c * CHUNK * WIN_COLS;
      if (c < s.n_tri_chunks) {
        const int base = c * CHUNK;
        for (int j = 0; j < CHUNK; ++j) {
          if (tri_hit<true>(k, w + j * WIN_COLS, t) && t < best_t) {
            best_t = t;
            best_type = 2;
            best_idx = base + j;
          }
        }
      } else {
        const int base = (c - s.n_tri_chunks) * CHUNK;
        for (int j = 0; j < CHUNK; ++j) {
          const float* p = w + j * WIN_COLS;
          // sphere rows: pos[3] c2 valid; equal-t override of a real
          // (type > 0) incumbent restores the sphere-first priority
          if (sphere_hit(k, __ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4) > 0.0f, t) &&
              (t < best_t || (t == best_t && best_type > 0))) {
            best_t = t;
            best_type = 0;
            best_idx = base + j;
          }
        }
      }
    }
  }
  out_t[i] = best_t;
  out_type[i] = best_type;
  out_idx[i] = best_idx;
}

__global__ void chunked_any_kernel(ChunkArgs a, ChunkScene s, int32_t* out_occ, int n) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < s.small_len; k += blockDim.x) smem[k] = s.small[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const Ray r{a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i]};
  float best_t;
  int best_type, best_idx;
  sweep(small_view(smem, s), r, true, best_t, best_type, best_idx);
  bool occ = best_t < INF;

  if (!occ && a.lane_mask[i] != 0) {
    const RayTerms k = ray_terms(r);
    const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
    float t;
    for (int c = 0; c < s.n_chunks && !occ; ++c) {
      if (!slab_pass(s.bounds + 6 * c, r, ix, iy, iz, false, 0.0f)) continue;
      const float* w = s.win + (size_t)c * CHUNK * WIN_COLS;
      if (c < s.n_tri_chunks) {
        for (int j = 0; j < CHUNK && !occ; ++j) {
          occ = tri_occluded<true>(k, w + j * WIN_COLS);
        }
      } else {
        for (int j = 0; j < CHUNK && !occ; ++j) {
          const float* p = w + j * WIN_COLS;
          occ = sphere_hit(k, __ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4) > 0.0f, t);
        }
      }
    }
  }
  out_occ[i] = occ ? 1 : 0;
}

ChunkScene chunk_scene(const float* small, int small_len, int n_sph, int n_pln,
                       const float* bounds, const float* win, int n_tri_chunks, int n_chunks) {
  return ChunkScene{small, small_len, n_sph, n_pln, bounds, win, n_tri_chunks, n_chunks};
}

}  // namespace

extern "C" {

// p: 7 device pointers, ChunkArgs field order (ray components, live mask).
int rt_chunked_closest_launch(void** p, const float* small, int small_len, int n_sph, int n_pln,
                              const float* bounds, const float* win, int n_tri_chunks,
                              int n_chunks, float* out_t, int32_t* out_type, int32_t* out_idx,
                              int n, void* stream) {
  static_assert(sizeof(ChunkArgs) == 7 * sizeof(void*), "ChunkArgs layout");
  ChunkArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  const ChunkScene s = chunk_scene(small, small_len, n_sph, n_pln, bounds, win, n_tri_chunks, n_chunks);
  chunked_closest_kernel<<<(n + kThreads - 1) / kThreads, kThreads, small_len * sizeof(float),
                           (cudaStream_t)stream>>>(a, s, out_t, out_type, out_idx, n);
  return (int)cudaGetLastError();
}

// p: 7 device pointers, ChunkArgs field order (ray components, hit mask).
int rt_chunked_any_launch(void** p, const float* small, int small_len, int n_sph, int n_pln,
                          const float* bounds, const float* win, int n_tri_chunks, int n_chunks,
                          int32_t* out_occ, int n, void* stream) {
  static_assert(sizeof(ChunkArgs) == 7 * sizeof(void*), "ChunkArgs layout");
  ChunkArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  const ChunkScene s = chunk_scene(small, small_len, n_sph, n_pln, bounds, win, n_tri_chunks, n_chunks);
  chunked_any_kernel<<<(n + kThreads - 1) / kThreads, kThreads, small_len * sizeof(float),
                       (cudaStream_t)stream>>>(a, s, out_occ, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
