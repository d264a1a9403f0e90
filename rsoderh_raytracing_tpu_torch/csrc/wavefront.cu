// TRACE and SHADE: the two kernels of one free-run wavefront iteration.
//
// TRACE replaces the Pallas kernel rsoderh_raytracing_tpu/ops/
// pallas_wavefront.py:_trace_kernel (trace_call, pallas_call at :775):
// closest sweep over every sphere, plane and triangle (strict <, sphere ->
// plane -> triangle priority), winner normal and material, the NEE shadow
// sweep from the hit point, the NEE BSDF eval/pdf, the cosine or GGX-VNDF
// bounce sample (2 RNG draws, error sentinels) and the quad-row index.
// SHADE replaces pallas_wavefront.py:_shade_kernel/_shade_core
// (shade_call, pallas_call at :840): RGBE bilinear radiance, the texel
// pmf, MIS, emission, film, termination and regeneration.
//
// Design. One thread per lane over flat n-lane arrays (256 threads a
// block, ragged tail masked). The (32,128) tiles, SMEM windows and the
// hi/lo u32->f32 split of the Pallas version only served Mosaic. TRACE
// stages the packed scene table (house: 72 primitives + 8 materials,
// 9 KB; at most 192 primitives) in shared memory at block start; every
// thread of a warp then reads the same primitive, a broadcast.
//
// What bounds them on the H100. TRACE reads 14 and writes 26 four-byte
// values a lane (160 B) and runs about 2 x 72 primitive tests a lane for
// house; SHADE reads 53 and writes 22 (300 B) with little arithmetic, so
// it is bound by device memory bandwidth. This first version trades
// speed for parity with the plain PyTorch twins (ops/cuda_wavefront.py):
// it keeps the Pallas twins' 48 intermediate arrays and is built with
// -fmad=false so its float results follow the same roundings as the
// unfused PyTorch ops. Fusing the glue and TRACE into SHADE, and dropping
// the intermediate arrays, is later work.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "wavefront_common.cuh"

using namespace rt;

namespace {

struct SceneView {
  const float* sph;
  const float* pln;
  const float* tri;
  const float* mat;
  int n_sph, n_pln, n_tri, n_mat;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// pallas_intersect._sweep_body, one lane. With any_only, returns at the
// first hit closer than INF (the occlusion test needs no winner).
__device__ __forceinline__ void sweep(const SceneView& s, const Ray& r, bool any_only,
                                      float& best_t, int& best_type, int& best_idx) {
  const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
  const float a_q = dx * dx + dy * dy + dz * dz;
  const float d_dot_o = dx * ox + dy * oy + dz * oz;
  const float o_dot_o = ox * ox + oy * oy + oz * oz;
  const float mx = oy * dz - oz * dy;
  const float my = oz * dx - ox * dz;
  const float mz = ox * dy - oy * dx;
  best_t = INF;
  best_type = -1;
  best_idx = 0;

  for (int i = 0; i < s.n_sph; ++i) {
    const float* p = s.sph + i * SPH_COLS;
    const float cx = p[0], cy = p[1], cz = p[2];
    float b = 2.0f * (d_dot_o - (dx * cx + dy * cy + dz * cz));
    float c = o_dot_o - 2.0f * (ox * cx + oy * cy + oz * cz) + p[3];
    float disc = b * b - 4.0f * a_q * c;
    float sq = sqrtf(maxn(disc, 0.0f));
    float q = b > 0.0f ? -0.5f * (b + sq) : -0.5f * (b - sq);
    float t0 = q / a_q;
    float t1 = c / (q == 0.0f ? 1.0f : q);
    float t = t0 < SPHERE_EPS ? t1 : (t1 < SPHERE_EPS ? t0 : minn(t0, t1));
    if (disc == 0.0f) t = -0.5f * b / a_q;
    bool hit = (disc >= 0.0f) && (t >= SPHERE_EPS) && (p[6] > 0.0f);
    if (hit && t < best_t) {
      best_t = t;
      best_type = 0;
      best_idx = i;
      if (any_only) return;
    }
  }
  for (int i = 0; i < s.n_pln; ++i) {
    const float* p = s.pln + i * PLN_COLS;
    const float nx = p[0], ny = p[1], nz = p[2];
    float denom = dx * nx + dy * ny + dz * nz;
    bool ok = fabsf(denom) >= PLANE_DENOM_EPS;
    float t = (p[3] - (ox * nx + oy * ny + oz * nz)) / (ok ? denom : 1.0f);
    float px = (ox * p[4] + oy * p[5] + oz * p[6]) + t * (dx * p[4] + dy * p[5] + dz * p[6]) - p[10];
    float pz = (ox * p[7] + oy * p[8] + oz * p[9]) + t * (dx * p[7] + dy * p[8] + dz * p[9]) - p[11];
    bool hit = ok && (t >= PLANE_T_EPS) && (px >= 0.0f) && (px <= 1.0f) && (pz >= 0.0f) &&
               (pz <= 1.0f) && (p[13] > 0.0f);
    if (hit && t < best_t) {
      best_t = t;
      best_type = 1;
      best_idx = i;
      if (any_only) return;
    }
  }
  for (int i = 0; i < s.n_tri; ++i) {
    const float* p = s.tri + i * TRI_COLS;
    float det = dx * p[0] + dy * p[1] + dz * p[2];
    bool ok = fabsf(det) >= TRI_DET_EPS;
    float inv = 1.0f / (ok ? det : 1.0f);
    float u = ((mx * p[6] + my * p[7] + mz * p[8]) + (dx * p[9] + dy * p[10] + dz * p[11])) * inv;
    float v = -((mx * p[3] + my * p[4] + mz * p[5]) + (dx * p[12] + dy * p[13] + dz * p[14])) * inv;
    float t = ((ox * p[15] + oy * p[16] + oz * p[17]) - p[18]) * inv;
    bool hit = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
               (t >= TRI_T_EPS) && (p[19] > 0.0f);
    if (hit && t < best_t) {
      best_t = t;
      best_type = 2;
      best_idx = i;
      if (any_only) return;
    }
  }
}

struct TraceArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *sx, *sy, *sz, *nu, *nv, *mu, *mv;
  const uint32_t* state;
  int32_t *hit, *occ;
  float *px, *py, *pz, *er, *eg, *eb, *ct, *ns0, *ns1, *ns2, *npdf;
  float *bd0, *bd1, *bd2, *bpdf, *bs0, *bs1, *bs2;
  int32_t* bz;
  float* cb;
  uint32_t* state_out;
  int32_t* qidx;
  float *fu, *fv;
};

__global__ void trace_kernel(TraceArgs a, const float* __restrict__ table, int table_len, int n,
                             int n_sph, int n_pln, int n_tri, int n_mat, int env_w, int env_h) {
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < table_len; k += blockDim.x) smem[k] = table[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  SceneView s;
  s.sph = smem;
  s.pln = s.sph + n_sph * SPH_COLS;
  s.tri = s.pln + n_pln * PLN_COLS;
  s.mat = s.tri + n_tri * TRI_COLS;
  s.n_sph = n_sph;
  s.n_pln = n_pln;
  s.n_tri = n_tri;
  s.n_mat = n_mat;

  Ray r{a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i]};
  const V3 rd{r.dx, r.dy, r.dz};
  const V3 nee{a.sx[i], a.sy[i], a.sz[i]};

  float best_t;
  int best_type, best_idx;
  sweep(s, r, false, best_t, best_type, best_idx);
  const bool did_hit = best_type >= 0;
  const float t_safe = did_hit ? best_t : 0.0f;
  const float px = r.ox + r.dx * t_safe;
  const float py = r.oy + r.dy * t_safe;
  const float pz = r.oz + r.dz * t_safe;

  // Winner attributes; a lane whose winner is another type reads row 0
  // (pallas_intersect.small_winner_normals / winner_rows).
  const float* sp = s.sph + (best_type == 0 ? best_idx : 0) * SPH_COLS;
  const float* pp = s.pln + (best_type == 1 ? best_idx : 0) * PLN_COLS;
  const float* tp = s.tri + (best_type == 2 ? best_idx : 0) * TRI_COLS;
  V3 normal;
  float mat_f;
  if (best_type == 0) {
    float snx = px - sp[0], sny = py - sp[1], snz = pz - sp[2];
    float inv_len = 1.0f / sqrtf(snx * snx + sny * sny + snz * snz);
    snx = snx * inv_len;
    sny = sny * inv_len;
    snz = snz * inv_len;
    float lx = sp[0] - r.ox, ly = sp[1] - r.oy, lz = sp[2] - r.oz;
    bool inside = (lx * lx + ly * ly + lz * lz) - sp[4] * sp[4] < (float)1.0e-6;
    normal = inside ? V3{-snx, -sny, -snz} : V3{snx, sny, snz};
    mat_f = sp[5];
  } else if (best_type == 1) {
    bool flip = r.ox * pp[0] + r.oy * pp[1] + r.oz * pp[2] < 0.0f;
    normal = flip ? V3{-pp[0], -pp[1], -pp[2]} : V3{pp[0], pp[1], pp[2]};
    mat_f = pp[12];
  } else {
    // pallas_intersect.tri_normal_recompute (misses take triangle row 0)
    const V3 ta{tp[20], tp[21], tp[22]}, e0{tp[3], tp[4], tp[5]}, e1{tp[6], tp[7], tp[8]};
    float rx = r.ox - ta.x, ry = r.oy - ta.y, rz = r.oz - ta.z;
    float p0x = ry * e0.z - rz * e0.y;
    float p0y = rz * e0.x - rx * e0.z;
    float p0z = rx * e0.y - ry * e0.x;
    float p1x = r.dy * e1.z - r.dz * e1.y;
    float p1y = r.dz * e1.x - r.dx * e1.z;
    float p1z = r.dx * e1.y - r.dy * e1.x;
    float det = e0.x * p1x + e0.y * p1y + e0.z * p1z;
    float inv_det = 1.0f / (fabsf(det) < TRI_DET_EPS ? 1.0f : det);
    float u = (rx * p1x + ry * p1y + rz * p1z) * inv_det;
    float v = (r.dx * p0x + r.dy * p0y + r.dz * p0z) * inv_det;
    float w0 = 1.0f - u - v;
    float tnx = w0 * tp[23] + u * tp[26] + v * tp[29];
    float tny = w0 * tp[24] + u * tp[27] + v * tp[30];
    float tnz = w0 * tp[25] + u * tp[28] + v * tp[31];
    float inv_tn = 1.0f / maxn(sqrtf(tnx * tnx + tny * tny + tnz * tnz), (float)1.0e-20);
    tnx = tnx * inv_tn;
    tny = tny * inv_tn;
    tnz = tnz * inv_tn;
    bool backface = tnx * r.dx + tny * r.dy + tnz * r.dz > 0.0f;
    normal = backface ? V3{-tnx, -tny, -tnz} : V3{tnx, tny, tnz};
    mat_f = tp[32];
  }
  int mat_id = (int)mat_f;
  const float* mp = s.mat + ((mat_id >= 0 && mat_id < n_mat) ? mat_id : 0) * MAT_COLS;
  const V3 color{mp[0], mp[1], mp[2]};
  const float rough = mp[3], metal = mp[4];

  // NEE occlusion: shadow sweep from the hit point.
  float occ_t;
  int occ_type, occ_idx;
  sweep(s, Ray{px, py, pz, nee.x, nee.y, nee.z}, true, occ_t, occ_type, occ_idx);

  // trace_epilogue: material parameters, NEE eval/pdf, bounce sample.
  const float alpha = maxn(rough * rough, (float)0.001);
  const float msat = sat(metal);
  const V3 f0{DIELECTRIC_F0 + (color.x - DIELECTRIC_F0) * msat,
              DIELECTRIC_F0 + (color.y - DIELECTRIC_F0) * msat,
              DIELECTRIC_F0 + (color.z - DIELECTRIC_F0) * msat};
  const float cos_theta = maxn(vdot(normal, nee), 0.0f);
  const Frame frame = make_frame(normal);
  const V3 wo = to_local(frame, V3{-rd.x, -rd.y, -rd.z});
  const V3 wi = to_local(frame, nee);
  const V3 nee_scatter = bsdf_eval(wo, wi, color, metal, alpha, f0);
  const float nee_pdf_b = bsdf_pdf(wo, wi, f0, alpha);
  uint32_t state = a.state[i];
  const BsdfSample bs = bsdf_sample(state, rd, normal, color, metal, alpha, f0);
  const float cos_bounce = maxn(vdot(normal, bs.dir), 0.0f);

  // quad fetch index at the fused uv
  const float fu = did_hit ? a.nu[i] : a.mu[i];
  const float fv = did_hit ? a.nv[i] : a.mv[i];

  a.hit[i] = did_hit ? 1 : 0;
  a.occ[i] = occ_t < INF ? 1 : 0;
  a.px[i] = px;
  a.py[i] = py;
  a.pz[i] = pz;
  a.er[i] = mp[5];
  a.eg[i] = mp[6];
  a.eb[i] = mp[7];
  a.ct[i] = cos_theta;
  a.ns0[i] = nee_scatter.x;
  a.ns1[i] = nee_scatter.y;
  a.ns2[i] = nee_scatter.z;
  a.npdf[i] = nee_pdf_b;
  a.bd0[i] = bs.dir.x;
  a.bd1[i] = bs.dir.y;
  a.bd2[i] = bs.dir.z;
  a.bpdf[i] = bs.pdf;
  a.bs0[i] = bs.scat.x;
  a.bs1[i] = bs.scat.y;
  a.bs2[i] = bs.scat.z;
  a.bz[i] = bs.zero_dir ? 1 : 0;
  a.cb[i] = cos_bounce;
  a.state_out[i] = state;
  a.qidx[i] = quad_x0(fv, env_h) * env_w + quad_x0(fu, env_w);
  a.fu[i] = fu;
  a.fv[i] = fv;
}

struct ShadeArgs {
  const uint4* quad;  // (n, 4) RGBE words at tr.qidx
  // trace products
  const int32_t *hit, *occ;
  const float *px, *py, *pz, *er, *eg, *eb, *ct, *ns0, *ns1, *ns2, *npdf;
  const float *bd0, *bd1, *bd2, *bpdf, *bs0, *bs1, *bs2;
  const int32_t* bz;
  const float* cb;
  const uint32_t* tstate;
  const float *fu, *fv, *npmf;
  // carry
  const float *tp0, *tp1, *tp2, *inc0, *inc1, *inc2, *last_pdf;
  const int32_t* bounce;
  const uint32_t* sample;
  const int32_t* in_path;
  const float *film0, *film1, *film2, *ro0, *ro1, *ro2, *rd0, *rd1, *rd2;
  // loop-invariant lanes
  const uint32_t* pixidx;
  const int32_t *pixx, *pixy;
  const uint32_t* base;
  // [max_y, aspect, cam pos[3], cam rot rows[9], L, Z]
  const float* scal;
  // outputs (SHADE_OUT_NAMES)
  uint32_t* o_state;
  float *o_ro0, *o_ro1, *o_ro2, *o_rd0, *o_rd1, *o_rd2;
  float *o_tp0, *o_tp1, *o_tp2, *o_inc0, *o_inc1, *o_inc2, *o_last_pdf;
  int32_t* o_bounce;
  uint32_t* o_sample;
  int32_t* o_in_path;
  float *o_film0, *o_film1, *o_film2;
  int32_t *o_active, *o_hitmask;
};

struct ShadeScalars {
  int n, env_w, env_h, width, height, max_bounces;
  uint32_t it_next, spp, budget, stride, offset;
};

__global__ void shade_kernel(ShadeArgs a, ShadeScalars k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k.n) return;
  const float* scal = a.scal;
  const int W = k.env_w, H = k.env_h;

  const bool active = a.in_path[i] != 0;
  const bool did_hit = a.hit[i] != 0;
  const bool is_hit = active && did_hit;
  const bool is_miss = active && !did_hit;
  V3 throughput{a.tp0[i], a.tp1[i], a.tp2[i]};
  V3 incoming{a.inc0[i], a.inc1[i], a.inc2[i]};
  const float fu = a.fu[i], fv = a.fv[i];

  // quad row -> bilinear radiance + texel pmf (envmap.py RGBE path)
  const float x = fu * (float)W - 0.5f;
  const float y = fv * (float)H - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x0 < 0.0f ? 0.0f : x - x0;
  const float fy = y0 < 0.0f ? 0.0f : y - y0;
  const int x0i = clampi(__float2int_rz(x0), 0, W - 1);
  const int y0i = clampi(__float2int_rz(y0), 0, H - 1);
  const uint4 q = a.quad[i];
  const V3 c00 = decode_rgbe(q.x), c10 = decode_rgbe(q.y), c01 = decode_rgbe(q.z),
           c11 = decode_rgbe(q.w);
  const V3 radiance{(c00.x * (1.0f - fx) + c10.x * fx) * (1.0f - fy) + (c01.x * (1.0f - fx) + c11.x * fx) * fy,
                    (c00.y * (1.0f - fx) + c10.y * fx) * (1.0f - fy) + (c01.y * (1.0f - fx) + c11.y * fx) * fy,
                    (c00.z * (1.0f - fx) + c10.z * fx) * (1.0f - fy) + (c01.z * (1.0f - fx) + c11.z * fx) * fy};
  const int pxsel = min(__float2int_rz(fu * (float)W), W - 1);
  const int pysel = min(__float2int_rz(fv * (float)H), H - 1);
  const bool sel_x = pxsel != x0i;
  const bool sel_y = pysel != y0i;
  const V3 selt = sel_y ? (sel_x ? c11 : c01) : (sel_x ? c10 : c00);
  const float l = lum(selt);
  const float sin_theta = sinf(((float)pysel + 0.5f) * (float)(NP_PI / H));
  const float length = scal[14], total = scal[15];
  const float quad_pmf = total > 0.0f ? ((l * sin_theta * length) / total) / length : 1.0f / length;
  const float pmf = is_hit ? a.npmf[i] : quad_pmf;
  const float solid = (float)((2.0 * PI_D / W) * (PI_D / H)) * maxn(sinf(PI_F * fv), (float)1.0e-6);
  const float pdf_env = pmf / solid;

  // miss: environment light with MIS
  const float lp = a.last_pdf[i];
  const float a2 = lp * lp, b2 = pdf_env * pdf_env;
  const float miss_weight = a2 / maxn(a2 + b2, (float)1.0e-30);
  incoming.x = incoming.x + (is_miss ? throughput.x * radiance.x * miss_weight : 0.0f);
  incoming.y = incoming.y + (is_miss ? throughput.y * radiance.y * miss_weight : 0.0f);
  incoming.z = incoming.z + (is_miss ? throughput.z * radiance.z * miss_weight : 0.0f);

  // hit: emission + NEE
  incoming.x = incoming.x + (is_hit ? throughput.x * a.er[i] : 0.0f);
  incoming.y = incoming.y + (is_hit ? throughput.y * a.eg[i] : 0.0f);
  incoming.z = incoming.z + (is_hit ? throughput.z * a.eb[i] : 0.0f);
  const float cos_theta = a.ct[i];
  const float npdf = a.npdf[i];
  const float e2 = pdf_env * pdf_env, n2 = npdf * npdf;
  const float nee_weight = e2 / maxn(e2 + n2, (float)1.0e-30);
  const bool nee_ok = is_hit && (cos_theta > 0.0f) && (pdf_env > 0.0f) && (a.occ[i] == 0);
  const float cos_over_pdf = cos_theta / maxn(pdf_env, (float)1.0e-30);
  incoming.x = incoming.x + (nee_ok ? throughput.x * nee_weight * radiance.x * a.ns0[i] * cos_over_pdf : 0.0f);
  incoming.y = incoming.y + (nee_ok ? throughput.y * nee_weight * radiance.y * a.ns1[i] * cos_over_pdf : 0.0f);
  incoming.z = incoming.z + (nee_ok ? throughput.z * nee_weight * radiance.z * a.ns2[i] * cos_over_pdf : 0.0f);

  // bounce / termination
  const bool bzero = a.bz[i] != 0;
  const V3 bscat{a.bs0[i], a.bs1[i], a.bs2[i]};
  if (is_hit && bzero) incoming = bscat;
  const float bpdf = a.bpdf[i];
  const float tp_scale = a.cb[i] / maxn(bpdf, (float)1.0e-30);
  const V3 new_tp{throughput.x * bscat.x * tp_scale, throughput.y * bscat.y * tp_scale,
                  throughput.z * bscat.z * tp_scale};
  const float tp_norm = sqrtf(new_tp.x * new_tp.x + new_tp.y * new_tp.y + new_tp.z * new_tp.z);
  int bounce = a.bounce[i] + 1;
  const bool continues = is_hit && !bzero && (bpdf > 0.0f) && (tp_norm >= THROUGHPUT_CUTOFF) &&
                         (bounce < k.max_bounces);
  const bool path_done = active && !continues;
  const float film0 = a.film0[i] + (path_done ? incoming.x : 0.0f);
  const float film1 = a.film1[i] + (path_done ? incoming.y : 0.0f);
  const float film2 = a.film2[i] + (path_done ? incoming.z : 0.0f);
  const uint32_t sample = a.sample[i];
  const uint32_t next_sample = path_done ? sample + 1u : sample;

  // regenerate: reseed from (pixel, global sample); unsigned compares,
  // so 0xFFFFFFFF means "no limit".
  const bool regen = path_done && (next_sample < k.spp) && (k.it_next < k.budget);
  const uint32_t global_sample = (a.base[i] + next_sample) * k.stride + k.offset;
  uint32_t fstate = 0u ^ a.pixidx[i];
  rng_next(fstate);
  fstate = fstate ^ global_sample;
  rng_next(fstate);
  const float ua = rng_uniform(fstate);
  const float angle = ua * (float)TWO_PI_CIRCLE_D;
  const float ur = rng_uniform(fstate);
  const float radius = sqrtf(ur);
  const float jx = radius * cosf(angle);
  const float jy = radius * sinf(angle);
  const float max_y = scal[0], aspect = scal[1];
  const float jpx = (float)a.pixx[i] + jx;
  const float jpy = (float)a.pixy[i] + jy;
  const float sxn = jpx / (float)k.width * 2.0f - 1.0f;
  const float syn = -(jpy / (float)k.height * 2.0f - 1.0f);
  const float rc0 = sxn * max_y * aspect;
  const float rc1 = syn * max_y;
  float fd0 = rc0 * scal[5] + rc1 * scal[6] - scal[7];
  float fd1 = rc0 * scal[8] + rc1 * scal[9] - scal[10];
  float fd2 = rc0 * scal[11] + rc1 * scal[12] - scal[13];
  const float fnorm = sqrtf(fd0 * fd0 + fd1 * fd1 + fd2 * fd2);
  fd0 = fd0 / fnorm;
  fd1 = fd1 / fnorm;
  fd2 = fd2 / fnorm;

  const bool in_path = (active && continues) || regen;
  a.o_state[i] = regen ? fstate : a.tstate[i];
  a.o_ro0[i] = regen ? scal[2] + 0.0f : (continues ? a.px[i] : a.ro0[i]);
  a.o_ro1[i] = regen ? scal[3] + 0.0f : (continues ? a.py[i] : a.ro1[i]);
  a.o_ro2[i] = regen ? scal[4] + 0.0f : (continues ? a.pz[i] : a.ro2[i]);
  a.o_rd0[i] = regen ? fd0 : (continues ? a.bd0[i] : a.rd0[i]);
  a.o_rd1[i] = regen ? fd1 : (continues ? a.bd1[i] : a.rd1[i]);
  a.o_rd2[i] = regen ? fd2 : (continues ? a.bd2[i] : a.rd2[i]);
  a.o_tp0[i] = regen ? 1.0f : (continues ? new_tp.x : throughput.x);
  a.o_tp1[i] = regen ? 1.0f : (continues ? new_tp.y : throughput.y);
  a.o_tp2[i] = regen ? 1.0f : (continues ? new_tp.z : throughput.z);
  const bool clear = regen || path_done;
  a.o_inc0[i] = clear ? 0.0f : incoming.x;
  a.o_inc1[i] = clear ? 0.0f : incoming.y;
  a.o_inc2[i] = clear ? 0.0f : incoming.z;
  a.o_last_pdf[i] = regen ? 1.0f : (continues ? bpdf : lp);
  a.o_bounce[i] = regen ? 0 : bounce;
  a.o_sample[i] = next_sample;
  a.o_in_path[i] = in_path ? 1 : 0;
  a.o_film0[i] = film0;
  a.o_film1[i] = film1;
  a.o_film2[i] = film2;
  a.o_active[i] = active ? 1 : 0;
  a.o_hitmask[i] = is_hit ? 1 : 0;
}

constexpr int kThreads = 256;


}  // namespace

extern "C" {

// p: 40 device pointers, TraceArgs field order (13 f32 inputs, the u32
// state, then the 26 outputs in TRACE_OUT_NAMES order).
int rt_trace_launch(void** p, const float* table, int table_len, int n, int n_sph, int n_pln,
                    int n_tri, int n_mat, int env_w, int env_h, void* stream) {
  static_assert(sizeof(TraceArgs) == 40 * sizeof(void*), "TraceArgs layout");
  TraceArgs a;
  memcpy(&a, p, sizeof(a));
  if (n <= 0) return 0;
  size_t smem = (size_t)table_len * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  trace_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, (cudaStream_t)stream>>>(
      a, table, table_len, n, n_sph, n_pln, n_tri, n_mat, env_w, env_h);
  return (int)cudaGetLastError();
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

const char* rt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
