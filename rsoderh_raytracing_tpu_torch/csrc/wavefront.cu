// TRACE, SHADE and BIG_SHADE: the per-lane kernels of one free-run
// wavefront iteration.
//
// TRACE replaces the Pallas kernel rsoderh_raytracing_tpu/ops/
// pallas_wavefront.py:_trace_kernel (trace_call, pallas_call at :775)
// together with the XLA glue around it (render/wavefront.py:928-938 and
// its quad-row take): the alias-table draw of the NEE texel (4 RNG draws,
// one 16-byte alias row), the NEE direction, closest sweep over every
// sphere, plane and triangle (strict <, sphere -> plane -> triangle
// priority), winner normal and material, the NEE shadow sweep from the hit
// point, the NEE BSDF eval/pdf, the cosine or GGX-VNDF bounce sample (2
// RNG draws, error sentinels), the miss uv and the 16-byte quad row at the
// fused uv. The TPU version left the draw, the uv math and both row reads
// to XLA because Mosaic had no dynamic gather; here a lane reads its two
// rows with __ldg, one 32-byte sector each.
// SHADE replaces pallas_wavefront.py:_shade_kernel/_shade_core
// (shade_call, pallas_call at :840): RGBE bilinear radiance, the texel
// pmf, MIS, emission, film, termination and regeneration.
// BIG_SHADE replaces pallas_wavefront.py:_big_shade_kernel (big_shade_call,
// pallas_call at :1042), the big-mesh route's shade: the winner's row of
// the 20-float union table (read here at the winner's global index, so the
// 19 slot arrays of the Pallas call are never written), its normal and
// material, trace_epilogue, then the same SHADE core.
//
// Design. One thread per lane over flat n-lane arrays (256 threads a
// block, ragged tail masked). The (32,128) tiles, SMEM windows and the
// hi/lo u32->f32 split of the Pallas version only served Mosaic. TRACE
// stages the packed scene table (house: 72 primitives + 8 materials,
// 9 KB; house_tiled16, past Mosaic's 192-lane unroll budget: 328
// primitives, 26 KB) in shared memory at block start where it fits
// (SWEEP_MAX_TABLE_BYTES) and reads a larger table (house_tiled64: 272 KB)
// from global memory (stage_scene); every
// thread of a warp then reads the same primitive, a broadcast. SHADE and
// BIG_SHADE share shade_core (wavefront_common.cuh), so they cannot drift
// apart.
//
// What bounds them on the H100. TRACE reads 7 four-byte values and two
// 16-byte rows and writes 26 four-byte values and a 16-byte row a lane
// (180 B) and runs the closest sweep over every primitive plus the
// shadow sweep up to its first hit (5,009 operations a lane on house), so
// it is bound by operations; the shared sweep rejects a primitive by a
// division-free pre-test before its divisions (wavefront_common.cuh).
// SHADE reads 53 and writes 22 (300 B) with little arithmetic, so it is
// bound by device memory bandwidth. BIG_SHADE reads 43 four-byte values,
// the 16-byte quad row and one 80-byte winner row (a random row of a table
// that sits in L2) and writes 22: about 340 B a lane, also bound by
// bandwidth. The kernels are built with -fmad=false so their float
// results follow the same roundings as the unfused PyTorch ops of their
// plain twins (ops/cuda_wavefront.py); TRACE's alias index, NEE pmf and
// quad row are bitwise its plain version's.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "wavefront_common.cuh"

using namespace rt;

namespace {

constexpr int kThreads = 256;

// The carry's ray and RNG state in; the 27 outputs (TRACE_OUT_NAMES) out.
struct TraceArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const uint32_t* state;
  int32_t *hit, *occ;
  float *px, *py, *pz, *er, *eg, *eb, *ct, *ns0, *ns1, *ns2, *npdf;
  float *bd0, *bd1, *bd2, *bpdf, *bs0, *bs1, *bs2;
  int32_t* bz;
  float* cb;
  uint32_t* state_out;
  float *fu, *fv, *nee_pmf;
  uint4* quad_out;
};

// The environment TRACE reads: (W*H) alias rows [probability,
// alias_index bits, pmf_self, pmf_alias] and RGBE quad rows, 16 bytes each.
struct EnvRows {
  const float4* alias;
  const uint4* quad;
  int w, h;
};

// ops/envmap.py:direction_to_equirect_uv and equirect_uv_to_direction, with
// the reference shader's truncated PI.
constexpr float INV_PI_HALF = (float)((1.0 / PI_D) * 0.5);
constexpr float INV_PI_F = (float)(1.0 / PI_D);

// Six blocks of 256 a multiprocessor cap TRACE at 40 registers (69
// unbounded): it spills some 136 bytes a thread, yet at the occupancy this
// buys it ran 5.7% faster on an H100 (PERF.md, PR 5).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 6)
    trace_kernel(TraceArgs a, const float* __restrict__ table, int table_len, int n, int n_sph,
                 int n_pln, int n_tri, int n_mat, EnvRows env) {
  extern __shared__ float smem[];
  const SceneView s = stage_scene<kStaged>(smem, table, table_len, n_sph, n_pln, n_tri, n_mat);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // The alias draw (envmap.sample_alias_index): index, accept, jitter x,
  // jitter y. Column 1 of the alias row holds the alias index's bits.
  uint32_t state = a.state[i];
  const int length = env.w * env.h;
  int index = min(__float2int_rz(rng_uniform(state) * (float)length), length - 1);
  const float u_accept = rng_uniform(state);
  const float4 pair = __ldg(env.alias + index);
  const bool keep = u_accept < pair.x;
  index = keep ? index : __float_as_int(pair.y);
  const float nee_pmf = keep ? pair.z : pair.w;
  const float jitter_x = rng_uniform(state);
  const float jitter_y = rng_uniform(state);
  const float nu = ((float)(index % env.w) + jitter_x) / (float)env.w;
  const float nv = ((float)(index / env.w) + jitter_y) / (float)env.h;
  // the NEE direction at (nu, nv)
  const float phi = (2.0f * nu - 1.0f) * PI_F;
  const float theta = PI_F * nv;
  const float sin_theta = sinf(theta);
  const V3 nee{sin_theta * cosf(phi), cosf(theta), sin_theta * sinf(phi)};

  const Ray r{a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i]};
  const V3 rd{r.dx, r.dy, r.dz};
  const TraceAttrs t = trace_attrs(s, r, nee);
  const bool did_hit = t.did_hit;
  const float px = t.px, py = t.py, pz = t.pz;
  const float* mp = t.mat;
  const V3 color{mp[0], mp[1], mp[2]};

  const Epilogue e = trace_epilogue(rd, nee, t.normal, color, mp[3], mp[4], state);

  // the fused uv: the NEE sample's on a hit, the escaped ray's on a miss;
  // then its quad row
  const float fu = did_hit ? nu : atan2f(r.dz, r.dx) * INV_PI_HALF + 0.5f;
  const float fv = did_hit ? nv : 0.5f - asinf(minn(maxn(r.dy, -1.0f), 1.0f)) * INV_PI_F;
  a.quad_out[i] = __ldg(env.quad + quad_x0(fv, env.h) * env.w + quad_x0(fu, env.w));

  a.hit[i] = did_hit ? 1 : 0;
  a.occ[i] = t.occ ? 1 : 0;
  a.px[i] = px;
  a.py[i] = py;
  a.pz[i] = pz;
  a.er[i] = mp[5];
  a.eg[i] = mp[6];
  a.eb[i] = mp[7];
  a.ct[i] = e.cos_theta;
  a.ns0[i] = e.nee_scatter.x;
  a.ns1[i] = e.nee_scatter.y;
  a.ns2[i] = e.nee_scatter.z;
  a.npdf[i] = e.nee_pdf;
  a.bd0[i] = e.bs.dir.x;
  a.bd1[i] = e.bs.dir.y;
  a.bd2[i] = e.bs.dir.z;
  a.bpdf[i] = e.bs.pdf;
  a.bs0[i] = e.bs.scat.x;
  a.bs1[i] = e.bs.scat.y;
  a.bs2[i] = e.bs.scat.z;
  a.bz[i] = e.bs.zero_dir ? 1 : 0;
  a.cb[i] = e.cos_bounce;
  a.state_out[i] = state;
  a.fu[i] = fu;
  a.fv[i] = fv;
  a.nee_pmf[i] = nee_pmf;
}

// The carry and loop-invariant lanes SHADE and BIG_SHADE read; field
// order _SHADE_CARRY_IN, the 4 pixel arrays (ops/cuda_wavefront.py), scal.
struct CarryPtrs {
  const float *tp0, *tp1, *tp2, *inc0, *inc1, *inc2, *last_pdf;
  const int32_t* bounce;
  const uint32_t* sample;
  const int32_t* in_path;
  const float *film0, *film1, *film2, *ro0, *ro1, *ro2, *rd0, *rd1, *rd2;
  const uint32_t* pixidx;
  const int32_t *pixx, *pixy;
  const uint32_t* base;
  // [max_y, aspect, cam pos[3], cam rot rows[9], L, Z]
  const float* scal;
};

// Lane i's carry, pixel and quad row as shade_core reads them, each where
// it is used.
struct CarryIn {
  const CarryPtrs& c;
  const uint4* q;
  int i;
  __device__ float tp(int k) const { return (k == 0 ? c.tp0 : k == 1 ? c.tp1 : c.tp2)[i]; }
  __device__ float inc(int k) const { return (k == 0 ? c.inc0 : k == 1 ? c.inc1 : c.inc2)[i]; }
  __device__ float film(int k) const { return (k == 0 ? c.film0 : k == 1 ? c.film1 : c.film2)[i]; }
  __device__ float ro(int k) const { return (k == 0 ? c.ro0 : k == 1 ? c.ro1 : c.ro2)[i]; }
  __device__ float rd(int k) const { return (k == 0 ? c.rd0 : k == 1 ? c.rd1 : c.rd2)[i]; }
  __device__ float last_pdf() const { return c.last_pdf[i]; }
  __device__ int bounce() const { return c.bounce[i]; }
  __device__ uint32_t sample() const { return c.sample[i]; }
  __device__ bool in_path() const { return c.in_path[i] != 0; }
  __device__ uint32_t pixidx() const { return c.pixidx[i]; }
  __device__ int pixx() const { return c.pixx[i]; }
  __device__ int pixy() const { return c.pixy[i]; }
  __device__ uint32_t base() const { return c.base[i]; }
  __device__ uint4 quad() const { return q[i]; }
};

struct ShadeArgs {
  const uint4* quad;  // (n, 4) RGBE words: TRACE's quad row at the fused uv
  // trace products
  const int32_t *hit, *occ;
  const float *px, *py, *pz, *er, *eg, *eb, *ct, *ns0, *ns1, *ns2, *npdf;
  const float *bd0, *bd1, *bd2, *bpdf, *bs0, *bs1, *bs2;
  const int32_t* bz;
  const float* cb;
  const uint32_t* tstate;
  const float *fu, *fv, *npmf;
  CarryPtrs c;
  ShadeOut o;
};

// SHADE's inputs: the trace products from device memory.
struct ShadeIn : CarryIn {
  const ShadeArgs& a;
  __device__ ShadeIn(const ShadeArgs& args, int lane) : CarryIn{args.c, args.quad, lane}, a(args) {}
  __device__ bool hit() const { return a.hit[i] != 0; }
  __device__ bool occ() const { return a.occ[i] != 0; }
  __device__ float px() const { return a.px[i]; }
  __device__ float py() const { return a.py[i]; }
  __device__ float pz() const { return a.pz[i]; }
  __device__ float er() const { return a.er[i]; }
  __device__ float eg() const { return a.eg[i]; }
  __device__ float eb() const { return a.eb[i]; }
  __device__ float ct() const { return a.ct[i]; }
  __device__ float ns(int k) const { return (k == 0 ? a.ns0 : k == 1 ? a.ns1 : a.ns2)[i]; }
  __device__ float npdf() const { return a.npdf[i]; }
  __device__ float bd(int k) const { return (k == 0 ? a.bd0 : k == 1 ? a.bd1 : a.bd2)[i]; }
  __device__ float bpdf() const { return a.bpdf[i]; }
  __device__ float bs(int k) const { return (k == 0 ? a.bs0 : k == 1 ? a.bs1 : a.bs2)[i]; }
  __device__ bool bz() const { return a.bz[i] != 0; }
  __device__ float cb() const { return a.cb[i]; }
  __device__ uint32_t state() const { return a.tstate[i]; }
  __device__ float fu() const { return a.fu[i]; }
  __device__ float fv() const { return a.fv[i]; }
  __device__ float npmf() const { return a.npmf[i]; }
};

__global__ void shade_kernel(ShadeArgs a, ShadeScalars k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k.n) return;
  shade_core(i, ShadeIn(a, i), a.c.scal, k, a.o);
}

struct BigShadeArgs {
  const uint4* quad;  // (n, 4) RGBE words at the fused uv's quad row
  const int32_t *hit, *occ, *btype, *bidx;
  const float *px, *py, *pz;
  const float *sx, *sy, *sz;  // NEE direction
  const uint32_t* state;      // after the alias draw
  const float *fu, *fv, *npmf;
  CarryPtrs c;
  ShadeOut o;
};

// BIG_SHADE's inputs: the trace products computed in the kernel, the
// hit point, hit and occlusion flags, fused uv and NEE pmf from device
// memory.
struct BigShadeIn : CarryIn {
  const BigShadeArgs& a;
  V3 emission, nee_scatter, bdir, bscat;
  float cos_theta, nee_pdf, bpdf_, cos_bounce;
  bool bzero;
  uint32_t state_;
  __device__ BigShadeIn(const BigShadeArgs& args, int lane) : CarryIn{args.c, args.quad, lane}, a(args) {}
  __device__ bool hit() const { return a.hit[i] != 0; }
  __device__ bool occ() const { return a.occ[i] != 0; }
  __device__ float px() const { return a.px[i]; }
  __device__ float py() const { return a.py[i]; }
  __device__ float pz() const { return a.pz[i]; }
  __device__ float er() const { return emission.x; }
  __device__ float eg() const { return emission.y; }
  __device__ float eb() const { return emission.z; }
  __device__ float ct() const { return cos_theta; }
  __device__ float ns(int k) const { return k == 0 ? nee_scatter.x : k == 1 ? nee_scatter.y : nee_scatter.z; }
  __device__ float npdf() const { return nee_pdf; }
  __device__ float bd(int k) const { return k == 0 ? bdir.x : k == 1 ? bdir.y : bdir.z; }
  __device__ float bpdf() const { return bpdf_; }
  __device__ float bs(int k) const { return k == 0 ? bscat.x : k == 1 ? bscat.y : bscat.z; }
  __device__ bool bz() const { return bzero; }
  __device__ float cb() const { return cos_bounce; }
  __device__ uint32_t state() const { return state_; }
  __device__ float fu() const { return a.fu[i]; }
  __device__ float fv() const { return a.fv[i]; }
  __device__ float npmf() const { return a.npmf[i]; }
};

// wtable: (n_sph + n_pln + n_tri, WINNER_SLOTS) union rows
// (scene/device.py:winner_rows); mat: MAT_COLS material rows.
__global__ void big_shade_kernel(BigShadeArgs a, const float* __restrict__ wtable,
                                 const float* __restrict__ mat, int n_mat, int n_sph, int n_pln,
                                 ShadeScalars k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k.n) return;
  BigShadeIn in(a, i);
  const Ray r{in.ro(0), in.ro(1), in.ro(2), in.rd(0), in.rd(1), in.rd(2)};
  const int btype = a.btype[i], bidx = a.bidx[i];
  // global winner index; a miss reads row 0 (wavefront.py:1003-1009)
  const int gidx = btype == 0 ? bidx : (btype == 1 ? n_sph + bidx : (btype == 2 ? n_sph + n_pln + bidx : 0));
  float w[WINNER_SLOTS - 1];
  const float* row = wtable + (size_t)gidx * WINNER_SLOTS;
#pragma unroll
  for (int s = 0; s < WINNER_SLOTS - 1; ++s) w[s] = __ldg(row + s);

  // union slots: sphere pos[3] radius; plane normal[3]; triangle a[3]
  // e0[3] e1[3] n0[3] n1[3] n2[3]; slot 18 the material id
  V3 normal;
  if (btype == 0) {
    normal = sphere_normal(w[0], w[1], w[2], w[3], r, in.px(), in.py(), in.pz());
  } else if (btype == 1) {
    normal = plane_normal(w[0], w[1], w[2], r);
  } else {
    normal = tri_normal(V3{w[0], w[1], w[2]}, V3{w[3], w[4], w[5]}, V3{w[6], w[7], w[8]},
                        V3{w[9], w[10], w[11]}, V3{w[12], w[13], w[14]},
                        V3{w[15], w[16], w[17]}, r);
  }
  const float* mp = material_row(mat, n_mat, (int)w[18]);
  uint32_t state = a.state[i];
  const Epilogue e = trace_epilogue(V3{r.dx, r.dy, r.dz}, V3{a.sx[i], a.sy[i], a.sz[i]}, normal,
                                    V3{mp[0], mp[1], mp[2]}, mp[3], mp[4], state);
  in.emission = V3{mp[5], mp[6], mp[7]};
  in.cos_theta = e.cos_theta;
  in.nee_scatter = e.nee_scatter;
  in.nee_pdf = e.nee_pdf;
  in.bdir = e.bs.dir;
  in.bpdf_ = e.bs.pdf;
  in.bscat = e.bs.scat;
  in.bzero = e.bs.zero_dir;
  in.cos_bounce = e.cos_bounce;
  in.state_ = state;
  shade_core(i, in, a.c.scal, k, a.o);
}

}  // namespace

extern "C" {

// p: 34 device pointers, TraceArgs field order (6 f32 ray inputs, the u32
// state, then the 27 outputs in TRACE_OUT_NAMES order); alias and quad:
// the environment's (env_w * env_h, 4) rows.
int rt_trace_launch(void** p, const float* table, int table_len, int n, int n_sph, int n_pln,
                    int n_tri, int n_mat, const void* alias, const void* quad, int env_w,
                    int env_h, void* stream) {
  static_assert(sizeof(TraceArgs) == 34 * sizeof(void*), "TraceArgs layout");
  TraceArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  const EnvRows env{(const float4*)alias, (const uint4*)quad, env_w, env_h};
  return launch_sweep(trace_kernel<true>, trace_kernel<false>, table_len, n, kThreads, stream, a,
                      table, table_len, n, n_sph, n_pln, n_tri, n_mat, env);
}

// p: 73 device pointers, ShadeArgs field order.
int rt_shade_launch(void** p, int n, int env_w, int env_h, int width, int height,
                    int max_bounces, uint32_t it_next, uint32_t spp, uint32_t budget,
                    uint32_t stride, uint32_t offset, void* stream) {
  static_assert(sizeof(ShadeArgs) == 73 * sizeof(void*), "ShadeArgs layout");
  ShadeArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  ShadeScalars k{n, env_w, env_h, width, height, max_bounces, it_next, spp, budget, stride, offset};
  shade_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(a, k);
  return (int)cudaGetLastError();
}

// p: 61 device pointers, BigShadeArgs field order.
int rt_big_shade_launch(void** p, const float* wtable, const float* mat, int n_mat, int n_sph,
                        int n_pln, int n, int env_w, int env_h, int width, int height,
                        int max_bounces, uint32_t it_next, uint32_t spp, uint32_t budget,
                        uint32_t stride, uint32_t offset, void* stream) {
  static_assert(sizeof(BigShadeArgs) == 61 * sizeof(void*), "BigShadeArgs layout");
  BigShadeArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  ShadeScalars k{n, env_w, env_h, width, height, max_bounces, it_next, spp, budget, stride, offset};
  big_shade_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      a, wtable, mat, n_mat, n_sph, n_pln, k);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
