// CLOSEST, ANY and FUSED: the small-scene sweeps as kernels of their own.
//
// They replace the three Pallas kernels of rsoderh_raytracing_tpu/ops/
// pallas_intersect.py that the scan integrator and the composed wavefront
// body reach:
//   CLOSEST  _closest_kernel (closest_sweep -> _call, pallas_call at :1624):
//            per ray (t, type, index) of the first minimal hit in sphere ->
//            plane -> triangle, index order; a miss is (3e38, -1, 0);
//   ANY      _any_kernel (any_sweep -> _call, the same pallas_call site):
//            1 where some primitive is hit at t < 3e38;
//   FUSED    _fused_kernel (fused_trace, pallas_call at :1964; body
//            trace_attrs_body): closest sweep, hit point, winner normal,
//            material values and the NEE shadow sweep from the hit point.
//
// Design. CLOSEST and ANY serve the scan integrator
// (render/integrator.py), which asks them about every lane at every
// bounce while only the live lanes (CLOSEST) or the live lanes that hit
// (ANY) use the answer: at 2048^2 on house all and 68% at bounce 0, 35%
// and 30% at bounce 3. So both take a lane mask. A block of 256 threads
// owns 256 lanes: it packs the set lanes into a list in shared memory in
// lane order (compact_block: a __ballot_sync a warp and a prefix over the
// warps' counts), writes the fixed record of every unset lane, and its
// first threads sweep the list, so the sweeping warps are dense and the
// warps past the list do no sweep; a block with no set lane stages
// nothing. The block stages the packed scene table (scene/device.py:
// pack_rows; house 9 KB, house_tiled16's 328 rows 26 KB) in shared memory
// where it fits (SWEEP_MAX_TABLE_BYTES; a larger one, house_tiled64's
// 272 KB, is read from global memory: stage_scene), and
// the threads of a warp read the same row at a time, a broadcast. Each
// kind's loop stops at its last valid row (the padding is trailing; house
// sweeps 2 + 2 + 52 of its 8 + 8 + 56 rows); indices stay those of the
// padded table. CLOSEST writes the hit record of intersect._hit_attributes
// and the 8 material values (closest_attrs, the closest half of FUSED's
// trace_attrs) from the staged table, so the integrator gathers no row.
// ANY stops at a lane's first hit (sweep's any_only); the Pallas kernel
// sweeps everything and tests best_t < INF, the same boolean. FUSED is
// one thread a lane over every row, as TRACE (wavefront_common.cuh:
// sweep, trace_attrs), so the sweeps of the scan integrator, of the
// composed body and of the kernel loop cannot drift apart. Measured and
// dropped (PERF.md, PR 6): 1,024-lane tiles, a resident wave fed 32-lane
// chunks from a counter, and ANY warps that walk the rows in a cycle and
// refill a thread from the list when its lane has its answer.
//
// What bounds them on the H100. CLOSEST reads the mask and writes 18
// four-byte values a lane, and reads 6 a live lane; ANY reads the mask
// and writes 1, and reads 6 a masked lane; FUSED reads 9 and writes 16
// (100 B). The valid-row sweep over house is 2,586 operations a lane (a
// fused multiply-add counted as two: the kernels are built with
// -fmad=false, so the card's issue rate halves the f32 peak the bound is
// taken against), so CLOSEST on every lane, ANY and FUSED are bound by
// operations; CLOSEST on a third of live lanes by bytes. Built with
// -fmad=false like the other kernels, so they round like the plain
// PyTorch versions (ops/intersect.py: closest_record, any_sweep,
// trace_attrs).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "wavefront_common.cuh"

using namespace rt;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The table staged and cut to the valid rows of each kind.
template <bool kStaged>
__device__ __forceinline__ SceneView stage_valid(float* smem, const float* __restrict__ table,
                                                 int table_len, int n_sph, int n_pln, int n_tri,
                                                 int n_mat, const int* rows) {
  SceneView s = stage_scene<kStaged>(smem, table, table_len, n_sph, n_pln, n_tri, n_mat);
  s.n_sph = rows[0];
  s.n_pln = rows[1];
  s.n_tri = rows[2];
  return s;
}

struct RayPtrs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
};

__device__ __forceinline__ Ray load_ray(const RayPtrs& r, int i) {
  return Ray{r.ox[i], r.oy[i], r.oz[i], r.dx[i], r.dy[i], r.dz[i]};
}

// Valid rows of each kind (sphere, plane, triangle), by value.
struct Rows {
  int n[3];
};

// The set lanes of the block's 256 (lane i is this thread's; every lane
// inside n is set without a mask) go to list in lane order, a ballot a
// warp and a prefix over the 8 warps' counts; returns their count and
// whether lane i is set. Every thread of the block calls it; it ends
// with a barrier. counts: kWarps ints of shared memory.
__device__ __forceinline__ int compact_block(const int32_t* __restrict__ mask, int i, int n,
                                             int* list, int* counts, bool& set) {
  const int warp = threadIdx.x >> 5, me = threadIdx.x & 31;
  set = i < n && (mask == nullptr || mask[i] != 0);
  const unsigned ballot = __ballot_sync(kFull, set);
  if (me == 0) counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = counts[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (set) list[before + __popc(ballot & ((1u << me) - 1u))] = i;
  __syncthreads();
  return total;
}

// CLOSEST's outputs (cuda_intersect.CLOSEST_OUT_NAMES): the winner, the
// hit point, normal and material id, and the 8 material values.
struct ClosestArgs {
  RayPtrs r;
  const int32_t* live;  // may be null: every lane
  float* t;
  int32_t *type, *index;
  float *px, *py, *pz, *nx, *ny, *nz;
  int32_t* mat_id;
  float* mat[MAT_COLS];
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) closest_kernel(ClosestArgs a, const float* __restrict__ table,
                                                           int table_len, int n, int n_sph, int n_pln,
                                                           int n_tri, int n_mat, Rows rows) {
  extern __shared__ float smem[];
  __shared__ int list[kThreads];
  __shared__ int counts[kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool set;
  const int live = compact_block(a.live, i, n, list, counts, set);
  if (i < n && !set) {  // a dead lane: the miss record, zero attributes
    a.t[i] = INF;
    a.type[i] = -1;
    a.index[i] = 0;
    a.px[i] = a.py[i] = a.pz[i] = 0.0f;
    a.nx[i] = a.ny[i] = a.nz[i] = 0.0f;
    a.mat_id[i] = 0;
#pragma unroll
    for (int c = 0; c < MAT_COLS; ++c) a.mat[c][i] = 0.0f;
  }
  if (live == 0) return;  // block-uniform, so no thread misses the staging barrier
  const SceneView s =
      stage_valid<kStaged>(smem, table, table_len, n_sph, n_pln, n_tri, n_mat, rows.n);
  if ((int)threadIdx.x >= live) return;  // whole warps past the list do no sweep
  const int j = list[threadIdx.x];
  const HitAttrs h = closest_attrs(s, load_ray(a.r, j));
  a.t[j] = h.t;
  a.type[j] = h.type;
  a.index[j] = h.idx;
  a.px[j] = h.px;
  a.py[j] = h.py;
  a.pz[j] = h.pz;
  a.nx[j] = h.normal.x;
  a.ny[j] = h.normal.y;
  a.nz[j] = h.normal.z;
  a.mat_id[j] = h.mat_id;
#pragma unroll
  for (int c = 0; c < MAT_COLS; ++c) a.mat[c][j] = h.mat[c];
}

struct AnyArgs {
  RayPtrs r;
  const int32_t* mask;  // may be null: every lane
  int32_t* hit;
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) any_kernel(AnyArgs a, const float* __restrict__ table,
                                                       int table_len, int n, int n_sph, int n_pln,
                                                       int n_tri, Rows rows) {
  extern __shared__ float smem[];
  __shared__ int list[kThreads];
  __shared__ int counts[kWarps];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool set;
  const int masked = compact_block(a.mask, i, n, list, counts, set);
  if (i < n && !set) a.hit[i] = 0;
  if (masked == 0) return;
  const SceneView s = stage_valid<kStaged>(smem, table, table_len, n_sph, n_pln, n_tri, 0, rows.n);
  if ((int)threadIdx.x >= masked) return;
  const int j = list[threadIdx.x];
  float best_t;
  int best_type, best_idx;
  sweep(s, load_ray(a.r, j), true, best_t, best_type, best_idx);
  a.hit[j] = best_t < INF ? 1 : 0;
}

struct FusedArgs {
  RayPtrs r;
  const float *sx, *sy, *sz;  // NEE direction
  int32_t* hit;
  float *px, *py, *pz, *nx, *ny, *nz, *cr, *cg, *cb, *rough, *metal, *er, *eg, *eb;
  int32_t* occ;
};

template <bool kStaged>
__global__ void fused_kernel(FusedArgs a, const float* __restrict__ table, int table_len, int n,
                             int n_sph, int n_pln, int n_tri, int n_mat) {
  extern __shared__ float smem[];
  const SceneView s = stage_scene<kStaged>(smem, table, table_len, n_sph, n_pln, n_tri, n_mat);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const TraceAttrs t = trace_attrs(s, load_ray(a.r, i), V3{a.sx[i], a.sy[i], a.sz[i]});
  a.hit[i] = t.did_hit ? 1 : 0;
  a.px[i] = t.px;
  a.py[i] = t.py;
  a.pz[i] = t.pz;
  a.nx[i] = t.normal.x;
  a.ny[i] = t.normal.y;
  a.nz[i] = t.normal.z;
  a.cr[i] = t.mat[0];
  a.cg[i] = t.mat[1];
  a.cb[i] = t.mat[2];
  a.rough[i] = t.mat[3];
  a.metal[i] = t.mat[4];
  a.er[i] = t.mat[5];
  a.eg[i] = t.mat[6];
  a.eb[i] = t.mat[7];
  a.occ[i] = t.occ ? 1 : 0;
}

}  // namespace

extern "C" {

// p: 25 device pointers, ClosestArgs field order (6 f32 ray inputs, the
// i32 live mask or null, then t f32, type i32, index i32, 6 f32, mat_id
// i32, 8 f32); rows: the valid rows of each kind.
int rt_closest_launch(void** p, const float* table, int table_len, int n, int n_sph, int n_pln,
                      int n_tri, int n_mat, int rows_sph, int rows_pln, int rows_tri,
                      void* stream) {
  static_assert(sizeof(ClosestArgs) == 25 * sizeof(void*), "ClosestArgs layout");
  ClosestArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  return launch_sweep(closest_kernel<true>, closest_kernel<false>, table_len, n, kThreads, stream, a,
                      table, table_len, n, n_sph, n_pln, n_tri, n_mat,
                      Rows{{rows_sph, rows_pln, rows_tri}});
}

// p: 8 device pointers, AnyArgs field order (6 f32 ray inputs, the i32
// mask or null, hit i32); rows as for CLOSEST.
int rt_any_launch(void** p, const float* table, int table_len, int n, int n_sph, int n_pln,
                  int n_tri, int rows_sph, int rows_pln, int rows_tri, void* stream) {
  static_assert(sizeof(AnyArgs) == 8 * sizeof(void*), "AnyArgs layout");
  AnyArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  return launch_sweep(any_kernel<true>, any_kernel<false>, table_len, n, kThreads, stream, a, table,
                      table_len, n, n_sph, n_pln, n_tri, Rows{{rows_sph, rows_pln, rows_tri}});
}

// The dynamic shared memory that each of CLOSEST, ANY and FUSED can ask
// for on the current card: its opt-in limit less the kernel's static
// shared memory, the least of the three (what SWEEP_MAX_TABLE_BYTES
// assumes); -1 where the card cannot be asked.
int rt_sweep_max_table_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  const void* kernels[] = {(const void*)closest_kernel<true>, (const void*)any_kernel<true>,
                           (const void*)fused_kernel<true>};
  size_t fixed = 0;
  for (const void* k : kernels) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, k) != cudaSuccess) return -1;
    fixed = attr.sharedSizeBytes > fixed ? attr.sharedSizeBytes : fixed;
  }
  return optin - (int)fixed;
}

// p: 25 device pointers, FusedArgs field order (9 f32 inputs, then hit
// i32, 14 f32 outputs, occ i32).
int rt_fused_launch(void** p, const float* table, int table_len, int n, int n_sph, int n_pln,
                    int n_tri, int n_mat, void* stream) {
  static_assert(sizeof(FusedArgs) == 25 * sizeof(void*), "FusedArgs layout");
  FusedArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  return launch_sweep(fused_kernel<true>, fused_kernel<false>, table_len, n, kThreads, stream, a,
                      table, table_len, n, n_sph, n_pln, n_tri, n_mat);
}

}  // extern "C"
