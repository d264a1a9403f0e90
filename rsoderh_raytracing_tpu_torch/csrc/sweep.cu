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
// Design. One thread per lane over flat n-lane arrays, 256 threads a
// block, ragged tail masked. Each block stages the packed scene table
// (scene/device.py:pack_rows, at most 192 primitives; house 9 KB) in
// shared memory; the threads of a warp then read the same primitive row,
// a broadcast. The device functions are those of TRACE
// (wavefront_common.cuh: sweep, trace_attrs), so the sweeps of the scan
// integrator, of the composed body and of the kernel loop cannot drift
// apart. ANY stops at a lane's first hit (sweep's any_only); the Pallas
// kernel sweeps everything and tests best_t < INF, the same boolean.
//
// What bounds them on the H100. CLOSEST reads 6 and writes 3 four-byte
// values a lane (36 B), ANY 6 and 1 (28 B), FUSED 9 and 16 (100 B); the
// sweep over house's 72 primitive lanes is about 3,200 operations a lane,
// so all three are bound by operations, not bytes. Built with -fmad=false
// like the other kernels, so they round like the plain PyTorch versions
// (ops/intersect.py: closest_sweep, any_sweep, trace_attrs).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "wavefront_common.cuh"

using namespace rt;

namespace {

struct RayPtrs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
};

struct ClosestArgs {
  RayPtrs r;
  float* t;
  int32_t *type, *index;
};

__global__ void closest_kernel(ClosestArgs a, const float* __restrict__ table, int table_len,
                               int n, int n_sph, int n_pln, int n_tri) {
  extern __shared__ float smem[];
  const SceneView s = stage_scene(smem, table, table_len, n_sph, n_pln, n_tri, 0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t;
  int best_type, best_idx;
  sweep(s, Ray{a.r.ox[i], a.r.oy[i], a.r.oz[i], a.r.dx[i], a.r.dy[i], a.r.dz[i]}, false, best_t,
        best_type, best_idx);
  a.t[i] = best_t;
  a.type[i] = best_type;
  a.index[i] = best_idx;
}

struct AnyArgs {
  RayPtrs r;
  int32_t* hit;
};

__global__ void any_kernel(AnyArgs a, const float* __restrict__ table, int table_len, int n,
                           int n_sph, int n_pln, int n_tri) {
  extern __shared__ float smem[];
  const SceneView s = stage_scene(smem, table, table_len, n_sph, n_pln, n_tri, 0);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t;
  int best_type, best_idx;
  sweep(s, Ray{a.r.ox[i], a.r.oy[i], a.r.oz[i], a.r.dx[i], a.r.dy[i], a.r.dz[i]}, true, best_t,
        best_type, best_idx);
  a.hit[i] = best_t < INF ? 1 : 0;
}

struct FusedArgs {
  RayPtrs r;
  const float *sx, *sy, *sz;  // NEE direction
  int32_t* hit;
  float *px, *py, *pz, *nx, *ny, *nz, *cr, *cg, *cb, *rough, *metal, *er, *eg, *eb;
  int32_t* occ;
};

__global__ void fused_kernel(FusedArgs a, const float* __restrict__ table, int table_len, int n,
                             int n_sph, int n_pln, int n_tri, int n_mat) {
  extern __shared__ float smem[];
  const SceneView s = stage_scene(smem, table, table_len, n_sph, n_pln, n_tri, n_mat);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r{a.r.ox[i], a.r.oy[i], a.r.oz[i], a.r.dx[i], a.r.dy[i], a.r.dz[i]};
  const TraceAttrs t = trace_attrs(s, r, V3{a.sx[i], a.sy[i], a.sz[i]});
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

constexpr int kThreads = 256;

// Bytes of dynamic shared memory for the table; past 48 KB the kernel
// must opt in. Returns a CUDA error code.
template <class Kernel>
int reserve_table(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// p: 9 device pointers, ClosestArgs field order (6 f32 ray inputs, then
// t f32, type i32, index i32).
int rt_closest_launch(void** p, const float* table, int table_len, int n, int n_sph, int n_pln,
                      int n_tri, void* stream) {
  static_assert(sizeof(ClosestArgs) == 9 * sizeof(void*), "ClosestArgs layout");
  ClosestArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  const size_t smem = (size_t)table_len * sizeof(float);
  if (int err = reserve_table(closest_kernel, smem)) return err;
  closest_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, (cudaStream_t)stream>>>(
      a, table, table_len, n, n_sph, n_pln, n_tri);
  return (int)cudaGetLastError();
}

// p: 7 device pointers, AnyArgs field order (6 f32 ray inputs, hit i32).
int rt_any_launch(void** p, const float* table, int table_len, int n, int n_sph, int n_pln,
                  int n_tri, void* stream) {
  static_assert(sizeof(AnyArgs) == 7 * sizeof(void*), "AnyArgs layout");
  AnyArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  const size_t smem = (size_t)table_len * sizeof(float);
  if (int err = reserve_table(any_kernel, smem)) return err;
  any_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, (cudaStream_t)stream>>>(
      a, table, table_len, n, n_sph, n_pln, n_tri);
  return (int)cudaGetLastError();
}

// p: 25 device pointers, FusedArgs field order (9 f32 inputs, then hit
// i32, 14 f32 outputs, occ i32).
int rt_fused_launch(void** p, const float* table, int table_len, int n, int n_sph, int n_pln,
                    int n_tri, int n_mat, void* stream) {
  static_assert(sizeof(FusedArgs) == 25 * sizeof(void*), "FusedArgs layout");
  FusedArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  const size_t smem = (size_t)table_len * sizeof(float);
  if (int err = reserve_table(fused_kernel, smem)) return err;
  fused_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, (cudaStream_t)stream>>>(
      a, table, table_len, n, n_sph, n_pln, n_tri, n_mat);
  return (int)cudaGetLastError();
}

}  // extern "C"
