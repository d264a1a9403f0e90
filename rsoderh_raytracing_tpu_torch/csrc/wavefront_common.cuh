// Device functions shared by the kernels: TRACE, SHADE and BIG_SHADE
// (wavefront.cu), CHUNKED_CLOSEST and CHUNKED_ANY (chunked.cu), CLOSEST,
// ANY and FUSED (sweep.cu).
//
// Every formula follows rsoderh_raytracing_tpu/ops/pallas_wavefront.py
// and ops/pallas_intersect.py operand for operand. Constants that the
// reference writes as Python floats are rounded from double to float
// here too ((float)(x)), so they equal the reference's f32 constants.
// min/max/clamp propagate NaN like jnp.minimum/jnp.maximum/jnp.clip
// (fminf/fmaxf would drop it).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rt {

constexpr double PI_D = 3.14159;  // the reference shader's truncated PI
constexpr double NP_PI = 3.141592653589793;  // np.pi (alias-table pmf)
constexpr double TWO_PI_CIRCLE_D = 2.0 * 3.1415926;
constexpr float PI_F = (float)PI_D;
constexpr float INF = (float)3.0e38;

constexpr float SPHERE_EPS = (float)1.0e-4;
constexpr float PLANE_DENOM_EPS = (float)1.0e-4;
constexpr float PLANE_T_EPS = (float)1.0e-3;
constexpr float TRI_DET_EPS = (float)1.0e-8;
constexpr float TRI_T_EPS = (float)1.0e-5;
constexpr float DIELECTRIC_F0 = (float)0.04;
constexpr float THROUGHPUT_CUTOFF = (float)0.001;

// Packed scene table rows (scene/device.py:pack_rows).
constexpr int SPH_COLS = 8;   // pos[3] c2 radius material valid -
constexpr int PLN_COLS = 16;  // n[3] ndotp r0[3] r2[3] r0dotp r2dotp material valid - -
constexpr int TRI_COLS = 36;  // cdet[3] e0[3] e1[3] cu[3] cv[3] n[3] adotn valid a[3] n0[3] n1[3] n2[3] material - - -
constexpr int MAT_COLS = 8;   // color[3] roughness metallic emission[3]
// Big-mesh union rows (scene/device.py:winner_rows): sphere pos[3]
// radius; plane normal[3]; triangle a[3] e0[3] e1[3] n0[3] n1[3] n2[3];
// slot 18 the material id as an exact small-int float; slot 19 padding.
constexpr int WINNER_SLOTS = 20;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ bool isnan_(float x) { return x != x; }
// jnp.maximum(x, c) / jnp.minimum: NaN in, NaN out.
__device__ __forceinline__ float maxn(float x, float c) {
  return isnan_(x) ? x : (isnan_(c) ? c : (x > c ? x : c));
}
__device__ __forceinline__ float minn(float x, float c) {
  return isnan_(x) ? x : (isnan_(c) ? c : (x < c ? x : c));
}
__device__ __forceinline__ float sat(float x) { return minn(maxn(x, 0.0f), 1.0f); }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float vdot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 vscale(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 vsel(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ float vnorm_maxeps(V3 a) {
  return maxn(sqrtf(a.x * a.x + a.y * a.y + a.z * a.z), (float)1.0e-20);
}
__device__ __forceinline__ float lum(V3 c) {
  return (float)0.2126 * c.x + (float)0.7152 * c.y + (float)0.0722 * c.z;
}

// -- RNG (ops/rng.py): u32 arithmetic wraps natively here --------------------

__device__ __forceinline__ uint32_t rng_next(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  uint32_t shift = (state >> 28) + 4u;
  uint32_t result = ((state >> shift) ^ state) * 277803737u;
  return (result >> 22) ^ result;
}

// u32 -> f32 round-to-nearest-even (XLA's conversion), divided by
// 4294967295.0 as the reference writes it (2^32 once rounded to f32).
__device__ __forceinline__ float rng_uniform(uint32_t& state) {
  return __uint2float_rn(rng_next(state)) / (float)4294967295.0;
}

// -- RGBE decode (ops/envmap.py:decode_rgbe) ---------------------------------

__device__ __forceinline__ V3 decode_rgbe(uint32_t word) {
  float r = (float)(int)(word & 0xFFu);
  float g = (float)(int)((word >> 8) & 0xFFu);
  float b = (float)(int)((word >> 16) & 0xFFu);
  int e = (int)(word >> 24);
  int bits = clampi(e - 136 + 127, 1, 254) << 23;
  float scale = e == 0 ? 0.0f : __int_as_float(bits);
  return V3{r * scale, g * scale, b * scale};
}

// -- BSDF (pallas_wavefront.py:127-313) --------------------------------------

struct Frame {
  V3 t, b, n;
};

__device__ __forceinline__ Frame make_frame(V3 n) {
  bool use_z = fabsf(n.z) < (float)0.999;
  V3 helper{use_z ? 0.0f : 1.0f, 0.0f, use_z ? 1.0f : 0.0f};
  V3 t = vcross(helper, n);
  t = vscale(t, 1.0f / vnorm_maxeps(t));
  V3 b = vcross(n, t);
  return Frame{t, b, n};
}

__device__ __forceinline__ V3 to_local(const Frame& f, V3 v) {
  return V3{vdot(v, f.t), vdot(v, f.b), vdot(v, f.n)};
}

__device__ __forceinline__ V3 to_world(const Frame& f, V3 v) {
  V3 w{f.t.x * v.x + f.b.x * v.y + f.n.x * v.z,
       f.t.y * v.x + f.b.y * v.y + f.n.y * v.z,
       f.t.z * v.x + f.b.z * v.y + f.n.z * v.z};
  return vscale(w, 1.0f / vnorm_maxeps(w));
}

__device__ __forceinline__ float d_ggx(float ndh, float alpha) {
  float a2 = alpha * alpha;
  float denom = ndh * ndh * (a2 - 1.0f) + 1.0f;
  return a2 / (PI_F * denom * denom);
}

__device__ __forceinline__ float g1_ggx(float ndv, float alpha) {
  float ndv2 = ndv * ndv;
  float lam =
      (sqrtf(1.0f + alpha * alpha * (1.0f - ndv2) / maxn(ndv2, (float)1e-20)) - 1.0f) / 2.0f;
  return 1.0f / (1.0f + lam);
}

__device__ __forceinline__ V3 bsdf_eval(V3 wo, V3 wi, V3 color, float metallic, float alpha,
                                        V3 f0) {
  float ndo = wo.z, ndi = wi.z;
  bool valid = (ndo > 0.0f) && (ndi > 0.0f);
  V3 h{wo.x + wi.x, wo.y + wi.y, wo.z + wi.z};
  h = vscale(h, 1.0f / vnorm_maxeps(h));
  float ndh = sat(h.z);
  float d = d_ggx(ndh, alpha);
  float g = g1_ggx(ndo, alpha) * g1_ggx(ndi, alpha);
  float x = 1.0f - sat(vdot(h, wo));
  float x2 = x * x;
  float x5 = x2 * x2 * x;
  V3 fr{f0.x + (1.0f - f0.x) * x5, f0.y + (1.0f - f0.y) * x5, f0.z + (1.0f - f0.z) * x5};
  float denom = 4.0f * ndo * ndi;
  float fs_s = d * g / (valid ? denom : 1.0f);
  float kd0_s = 1.0f - sat(metallic);
  float fmax_s = 1.0f - maxn(f0.x, maxn(f0.y, f0.z));
  V3 kd{(color.x * kd0_s) * fmax_s, (color.y * kd0_s) * fmax_s, (color.z * kd0_s) * fmax_s};
  const float inv_pi = (float)(1.0 / PI_D);
  return V3{valid ? kd.x * inv_pi + fs_s * fr.x : 0.0f,
            valid ? kd.y * inv_pi + fs_s * fr.y : 0.0f,
            valid ? kd.z * inv_pi + fs_s * fr.z : 0.0f};
}

__device__ __forceinline__ float bsdf_pdf(V3 wo, V3 wi, V3 f0, float alpha) {
  float spec_p = sat(lum(f0));
  float diff_p = 1.0f - spec_p;
  V3 h{wo.x + wi.x, wo.y + wi.y, wo.z + wi.z};
  h = vscale(h, 1.0f / vnorm_maxeps(h));
  float wo_dot_h = fabsf(vdot(wo, h));
  float ndh = h.z;
  float pdf_half = d_ggx(ndh, alpha) * g1_ggx(wo.z, alpha) * maxn(vdot(wo, h), 0.0f) /
                   (wo.z == 0.0f ? 1.0f : wo.z);
  pdf_half = ndh <= 0.0f ? 0.0f : pdf_half;
  float pdf_spec = pdf_half / maxn(4.0f * wo_dot_h, (float)1.0e-20);
  pdf_spec = wo_dot_h <= 0.0f ? 0.0f : pdf_spec;
  float pdf_cos = wi.z <= 0.0f ? 0.0f : wi.z / PI_F;
  float pdf = diff_p * pdf_cos + spec_p * pdf_spec;
  return (wo.z > 0.0f && wi.z > 0.0f) ? pdf : 0.0f;
}

struct BsdfSample {
  V3 dir, scat;
  float pdf;
  bool zero_dir;
};

// ops/bsdf.py:bsdf_sample with its colored error sentinels; 2 RNG draws.
__device__ __forceinline__ BsdfSample bsdf_sample(uint32_t& state, V3 rd, V3 n, V3 color,
                                                  float metallic, float alpha, V3 f0) {
  V3 wo_world{-rd.x, -rd.y, -rd.z};
  bool bail_a = vdot(n, wo_world) <= 0.0f;
  Frame frame = make_frame(n);
  V3 wo = to_local(frame, wo_world);
  bool bail_b = wo.z <= 0.0f;

  float spec_p = sat(lum(f0));
  float diff_p = 1.0f - spec_p;
  float u1 = rng_uniform(state);
  float u2 = rng_uniform(state);

  // diffuse candidate (cosine hemisphere, u1 rescaled)
  float du = u1 / maxn(diff_p, (float)1.0e-6);
  float r_d = sqrtf(du);
  float phi_d = (float)(2.0 * PI_D) * u2;
  float dxl = r_d * cosf(phi_d);
  float dyl = r_d * sinf(phi_d);
  float dzl = sqrtf(maxn(1.0f - dxl * dxl - dyl * dyl, 0.0f));
  V3 wi_diff{dxl, dyl, dzl};

  // specular candidate (GGX VNDF)
  float su = (u1 - diff_p) / maxn(spec_p, (float)1.0e-6);
  V3 view{wo.x * alpha, wo.y * alpha, wo.z};
  view = vscale(view, 1.0f / vnorm_maxeps(view));
  float len_sq = view.x * view.x + view.y * view.y;
  // The reference's jax.lax.rsqrt, written as 1/sqrtf: this choice keeps
  // the kernel equal to its plain PyTorch twin (rsqrtf is approximate).
  float inv_len = 1.0f / sqrtf(maxn(len_sq, (float)1.0e-20));
  bool has_len = len_sq > 0.0f;
  V3 tx{has_len ? -view.y * inv_len : 1.0f, has_len ? view.x * inv_len : 0.0f, 0.0f};
  V3 ty = vcross(view, tx);
  float radius = sqrtf(su);
  float az = (float)(2.0 * PI_D) * u2;
  float dska = radius * cosf(az);
  float dskb_raw = radius * sinf(az);
  float dskb = (1.0f - view.z) * sqrtf(maxn(1.0f - dska * dska, 0.0f)) + view.z * dskb_raw;
  float hz = sqrtf(maxn(1.0f - dska * dska - dskb * dskb, 0.0f));
  V3 hst{dska * tx.x + dskb * ty.x + hz * view.x, dska * tx.y + dskb * ty.y + hz * view.y,
         dska * tx.z + dskb * ty.z + hz * view.z};
  V3 h{hst.x * alpha, hst.y * alpha, maxn(hst.z, 0.0f)};
  h = vscale(h, 1.0f / vnorm_maxeps(h));
  float wo_dot_h2 = 2.0f * vdot(wo, h);
  V3 wi_spec{wo_dot_h2 * h.x - wo.x, wo_dot_h2 * h.y - wo.y, wo_dot_h2 * h.z - wo.z};

  bool choose_diffuse = u1 < diff_p;
  V3 wi = vsel(choose_diffuse, wi_diff, wi_spec);
  bool spec_fail = !choose_diffuse && (wi_spec.z <= 0.0f);

  V3 scat = bsdf_eval(wo, wi, color, metallic, alpha, f0);
  float pdf = bsdf_pdf(wo, wi, f0, alpha);
  V3 wi_world = to_world(frame, wi);
  bool bail_c = vdot(n, wi_world) < 0.0f;

  const V3 zero3{0.0f, 0.0f, 0.0f}, red{1.0f, 0.0f, 0.0f}, green{0.0f, 1.0f, 0.0f},
      blue{0.0f, 0.0f, 1.0f};
  V3 dir = vsel(bail_c, zero3, wi_world);
  dir = vsel(spec_fail, red, dir);
  dir = vsel(bail_a || bail_b, zero3, dir);
  scat = vsel(bail_c, green, scat);
  scat = vsel(spec_fail, red, scat);
  scat = vsel(bail_b, green, scat);
  scat = vsel(bail_a, blue, scat);
  bool any_bail = bail_a || bail_b || bail_c || spec_fail;
  BsdfSample s;
  s.dir = dir;
  s.scat = scat;
  s.pdf = any_bail ? 0.0f : pdf;
  s.zero_dir = bail_a || bail_b || (bail_c && !spec_fail);
  return s;
}

// Row of the quad table for uv: floor(u*W - 0.5), clamped (envmap.py).
// __float2int_rz truncates toward zero, saturates and maps NaN to 0,
// like XLA's f32 -> i32 conversion.
__device__ __forceinline__ int quad_x0(float u, int w) {
  return clampi(__float2int_rz(floorf(u * (float)w - 0.5f)), 0, w - 1);
}

// -- primitive tests (pallas_intersect._sweep_body, one lane) ---------------
// sphere_hit, tri_hit and tri_occluded serve the chunked kernels' windows;
// sweep() below writes the same tests out for the packed table.

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// The per-ray terms every primitive test shares.
struct RayTerms {
  float ox, oy, oz, dx, dy, dz;
  float a_q, d_dot_o, o_dot_o, mx, my, mz;
};

__device__ __forceinline__ RayTerms ray_terms(const Ray& r) {
  RayTerms k;
  k.ox = r.ox; k.oy = r.oy; k.oz = r.oz; k.dx = r.dx; k.dy = r.dy; k.dz = r.dz;
  k.a_q = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  k.d_dot_o = r.dx * r.ox + r.dy * r.oy + r.dz * r.oz;
  k.o_dot_o = r.ox * r.ox + r.oy * r.oy + r.oz * r.oz;
  k.mx = r.oy * r.dz - r.oz * r.dy;
  k.my = r.oz * r.dx - r.ox * r.dz;
  k.mz = r.ox * r.dy - r.oy * r.dx;
  return k;
}

// Sphere at (cx, cy, cz) with c2 = |c|^2 - r^2: the robust q-form.
__device__ __forceinline__ bool sphere_hit(const RayTerms& k, float cx, float cy, float cz,
                                           float c2, bool valid, float& t) {
  float b = 2.0f * (k.d_dot_o - (k.dx * cx + k.dy * cy + k.dz * cz));
  float c = k.o_dot_o - 2.0f * (k.ox * cx + k.oy * cy + k.oz * cz) + c2;
  float disc = b * b - 4.0f * k.a_q * c;
  float sq = sqrtf(maxn(disc, 0.0f));
  float q = b > 0.0f ? -0.5f * (b + sq) : -0.5f * (b - sq);
  float t0 = q / k.a_q;
  float t1 = c / (q == 0.0f ? 1.0f : q);
  t = t0 < SPHERE_EPS ? t1 : (t1 < SPHERE_EPS ? t0 : minn(t0, t1));
  if (disc == 0.0f) t = -0.5f * b / k.a_q;
  return (disc >= 0.0f) && (t >= SPHERE_EPS) && valid;
}

// Column c of a row: a plain load, or (kLdg) a read-only __ldg for rows
// in global memory.
template <bool kLdg>
__device__ __forceinline__ float col(const float* p, int c) {
  return kLdg ? __ldg(p + c) : p[c];
}

// Triangle: the first 20 columns of a packed triangle row and of a chunk
// window row share one layout: cdet[3] e0[3] e1[3] cu[3] cv[3] n[3]
// adotn valid.
template <bool kLdg = false>
__device__ __forceinline__ bool tri_hit(const RayTerms& k, const float* p, float& t) {
  float det = k.dx * col<kLdg>(p, 0) + k.dy * col<kLdg>(p, 1) + k.dz * col<kLdg>(p, 2);
  bool ok = fabsf(det) >= TRI_DET_EPS;
  float inv = 1.0f / (ok ? det : 1.0f);
  float u = ((k.mx * col<kLdg>(p, 6) + k.my * col<kLdg>(p, 7) + k.mz * col<kLdg>(p, 8)) +
             (k.dx * col<kLdg>(p, 9) + k.dy * col<kLdg>(p, 10) + k.dz * col<kLdg>(p, 11))) * inv;
  float v = -((k.mx * col<kLdg>(p, 3) + k.my * col<kLdg>(p, 4) + k.mz * col<kLdg>(p, 5)) +
              (k.dx * col<kLdg>(p, 12) + k.dy * col<kLdg>(p, 13) + k.dz * col<kLdg>(p, 14))) * inv;
  t = ((k.ox * col<kLdg>(p, 15) + k.oy * col<kLdg>(p, 16) + k.oz * col<kLdg>(p, 17)) - col<kLdg>(p, 18)) * inv;
  return ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
         (t >= TRI_T_EPS) && (col<kLdg>(p, 19) > 0.0f);
}

// pallas_intersect.tri_chunk_occluded: tri_hit without the division,
// every quotient test in its sign-scaled numerator form.
template <bool kLdg = false>
__device__ __forceinline__ bool tri_occluded(const RayTerms& k, const float* p) {
  float det = k.dx * col<kLdg>(p, 0) + k.dy * col<kLdg>(p, 1) + k.dz * col<kLdg>(p, 2);
  float adet = fabsf(det);
  bool neg = det < 0.0f;
  float un = (k.mx * col<kLdg>(p, 6) + k.my * col<kLdg>(p, 7) + k.mz * col<kLdg>(p, 8)) +
             (k.dx * col<kLdg>(p, 9) + k.dy * col<kLdg>(p, 10) + k.dz * col<kLdg>(p, 11));
  un = neg ? -un : un;
  float vn = -((k.mx * col<kLdg>(p, 3) + k.my * col<kLdg>(p, 4) + k.mz * col<kLdg>(p, 5)) +
               (k.dx * col<kLdg>(p, 12) + k.dy * col<kLdg>(p, 13) + k.dz * col<kLdg>(p, 14)));
  vn = neg ? -vn : vn;
  float tn = (k.ox * col<kLdg>(p, 15) + k.oy * col<kLdg>(p, 16) + k.oz * col<kLdg>(p, 17)) - col<kLdg>(p, 18);
  tn = neg ? -tn : tn;
  return (adet >= TRI_DET_EPS) && (un >= 0.0f) && (un <= adet) && (vn >= 0.0f) &&
         (un + vn <= adet) && (tn >= TRI_T_EPS * adet) && (col<kLdg>(p, 19) > 0.0f);
}

// The packed scene table (scene/device.py:pack_rows), in shared memory
// or, past SWEEP_MAX_TABLE_BYTES, in global memory (stage_scene): sphere,
// plane, triangle and material rows.
struct SceneView {
  const float* sph;
  const float* pln;
  const float* tri;
  const float* mat;
  int n_sph, n_pln, n_tri, n_mat;
};

// The triangle pre-test's margins (modelled, with the same constants, by
// ops/intersect.py:prefilter_hits): a relative widening of 2^-20 of |det|
// on the u and v bounds and a t floor of TRI_T_EPS * (1 - 2^-20), rounded
// down. The divided test's roundings move u, v and t by a few 2^-24
// relative, and an underflow to -0 passes u >= 0 at |un| < 2^-149 |det|,
// so a primitive the divided test accepts always passes (PERF.md, PR 5).
constexpr float TRI_PRE_MARGIN = 0x1p-20f;
constexpr float TRI_PRE_ONE = 0x1.00001p+0f;      // 1 + 2^-20
constexpr float TRI_PRE_T_EPS = 0x1.4f8b44p-17f;  // f32(1e-5 * (1 - 2^-20))

// pallas_intersect._sweep_body, one lane: strict <, sphere -> plane ->
// triangle, index order. With any_only, returns at the first hit closer
// than INF (the occlusion test needs no winner). The primitive tests are
// written out here rather than through sphere_hit/tri_hit above (the same
// arithmetic): built on those helpers, TRACE ran 4.5% slower on the H100
// at equal registers (PERF.md).
//
// Each test first runs a division-free pre-test that every ray the exact
// test accepts passes (sphere: disc >= 0; plane: |denom| >= eps and the t
// numerator's sign against the denominator's; triangle: the sign-scaled
// u, v, t numerators of tri_occluded within the margins above; and the
// valid flag), and only then the divisions, square root and the exact
// test of pallas_intersect. The exact test's operands are computed as
// before, so hits, t, type and index are bitwise what they were; a warp
// whose rays all fail the pre-test skips the divisions.
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
    if (!((disc >= 0.0f) && (p[6] > 0.0f))) continue;
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
      if (any_only) return;
    }
  }
  for (int i = 0; i < s.n_pln; ++i) {
    const float* p = s.pln + i * PLN_COLS;
    const float nx = p[0], ny = p[1], nz = p[2];
    float denom = dx * nx + dy * ny + dz * nz;
    float num = p[3] - (ox * nx + oy * ny + oz * nz);
    // t >= PLANE_T_EPS > 0 needs num and denom nonzero and of one sign
    if (!((fabsf(denom) >= PLANE_DENOM_EPS) && (denom > 0.0f ? num > 0.0f : num < 0.0f) &&
          (p[13] > 0.0f)))
      continue;
    float t = num / denom;
    float px = (ox * p[4] + oy * p[5] + oz * p[6]) + t * (dx * p[4] + dy * p[5] + dz * p[6]) - p[10];
    float pz = (ox * p[7] + oy * p[8] + oz * p[9]) + t * (dx * p[7] + dy * p[8] + dz * p[9]) - p[11];
    bool hit = (t >= PLANE_T_EPS) && (px >= 0.0f) && (px <= 1.0f) && (pz >= 0.0f) && (pz <= 1.0f);
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
    float un = (mx * p[6] + my * p[7] + mz * p[8]) + (dx * p[9] + dy * p[10] + dz * p[11]);
    float vn = -((mx * p[3] + my * p[4] + mz * p[5]) + (dx * p[12] + dy * p[13] + dz * p[14]));
    float tn = (ox * p[15] + oy * p[16] + oz * p[17]) - p[18];
    float adet = fabsf(det);
    float us = det < 0.0f ? -un : un;
    float vs = det < 0.0f ? -vn : vn;
    float ts = det < 0.0f ? -tn : tn;
    if (!((adet >= TRI_DET_EPS) && (us >= -TRI_PRE_MARGIN * adet) && (us <= TRI_PRE_ONE * adet) &&
          (vs >= -TRI_PRE_MARGIN * adet) && (us + vs <= TRI_PRE_ONE * adet) &&
          (ts >= TRI_PRE_T_EPS * adet) && (p[19] > 0.0f)))
      continue;
    float inv = 1.0f / det;
    float u = un * inv;
    float v = vn * inv;
    float t = tn * inv;
    bool hit = (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t >= TRI_T_EPS);
    if (hit && t < best_t) {
      best_t = t;
      best_type = 2;
      best_idx = i;
      if (any_only) return;
    }
  }
}

// -- winner normals (pallas_intersect.small_winner_normals, tri_normal_recompute)

// Unit (p - c), flipped when the ray starts inside the sphere.
__device__ __forceinline__ V3 sphere_normal(float cx, float cy, float cz, float radius,
                                            const Ray& r, float px, float py, float pz) {
  float snx = px - cx, sny = py - cy, snz = pz - cz;
  float inv_len = 1.0f / sqrtf(snx * snx + sny * sny + snz * snz);
  snx = snx * inv_len;
  sny = sny * inv_len;
  snz = snz * inv_len;
  float lx = cx - r.ox, ly = cy - r.oy, lz = cz - r.oz;
  bool inside = (lx * lx + ly * ly + lz * lz) - radius * radius < (float)1.0e-6;
  return inside ? V3{-snx, -sny, -snz} : V3{snx, sny, snz};
}

// Plane normal flipped toward the side of the ray origin.
__device__ __forceinline__ V3 plane_normal(float nx, float ny, float nz, const Ray& r) {
  bool flip = r.ox * nx + r.oy * ny + r.oz * nz < 0.0f;
  return flip ? V3{-nx, -ny, -nz} : V3{nx, ny, nz};
}

// Naive Moller-Trumbore recompute on the winner triangle: barycentric
// blend of the baked normals + backface flip.
__device__ __forceinline__ V3 tri_normal(V3 ta, V3 e0, V3 e1, V3 n0, V3 n1, V3 n2, const Ray& r) {
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
  float tnx = w0 * n0.x + u * n1.x + v * n2.x;
  float tny = w0 * n0.y + u * n1.y + v * n2.y;
  float tnz = w0 * n0.z + u * n1.z + v * n2.z;
  float inv_tn = 1.0f / maxn(sqrtf(tnx * tnx + tny * tny + tnz * tnz), (float)1.0e-20);
  tnx = tnx * inv_tn;
  tny = tny * inv_tn;
  tnz = tnz * inv_tn;
  bool backface = tnx * r.dx + tny * r.dy + tnz * r.dz > 0.0f;
  return backface ? V3{-tnx, -tny, -tnz} : V3{tnx, tny, tnz};
}

// Material row (MAT_COLS layout); an id outside the table reads row 0.
__device__ __forceinline__ const float* material_row(const float* mat, int n_mat, int mat_id) {
  return mat + ((mat_id >= 0 && mat_id < n_mat) ? mat_id : 0) * MAT_COLS;
}

// The most dynamic shared memory a sweep kernel (TRACE, FUSED, CLOSEST,
// ANY) asks for to stage the packed table: a block's 232,448 bytes (227 KB,
// the H100's opt-in limit) less the 1,056 bytes of CLOSEST's and ANY's
// static lane list (sweep.cu). The table has no row cap: past 48 KB a
// launcher opts in (launch_sweep), and a table past this limit is not
// staged at all: every thread reads its rows from global memory, where the
// threads of a warp still read the same row at a time, through L1 and L2.
// scene/device.py mirrors the limit (SWEEP_MAX_SHARED);
// rt_sweep_max_table_bytes asks the card.
constexpr size_t SWEEP_MAX_TABLE_BYTES = 232448 - 1056;

__host__ __device__ __forceinline__ bool table_staged(int table_len) {
  return (size_t)table_len * sizeof(float) <= SWEEP_MAX_TABLE_BYTES;
}

// Launch the sweep kernel `kernel<true>` (the table staged) or
// `kernel<false>` (read from global memory) as table_staged says, with the
// dynamic shared memory that staging asks for (the kernel opts in past
// 48 KB); a CUDA error code. Two instantiations, so that the staged one's
// rows stay shared-memory loads.
template <class Kernel, class... Args>
int launch_sweep(Kernel staged, Kernel unstaged, int table_len, int n, int threads, void* stream,
                 Args... args) {
  const bool fits = table_staged(table_len);
  const Kernel kernel = fits ? staged : unstaged;
  const size_t smem = fits ? (size_t)table_len * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(n + threads - 1) / threads, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// The packed scene table's rows: with kStaged staged in shared memory
// (every thread of the block takes part, then a barrier), else read where
// it lies in global memory.
template <bool kStaged>
__device__ __forceinline__ SceneView stage_scene(float* smem, const float* __restrict__ table,
                                                 int table_len, int n_sph, int n_pln, int n_tri,
                                                 int n_mat) {
  const float* rows = table;
  if (kStaged) {
    for (int k = threadIdx.x; k < table_len; k += blockDim.x) smem[k] = table[k];
    __syncthreads();
    rows = smem;
  }
  SceneView s;
  s.sph = rows;
  s.pln = s.sph + n_sph * SPH_COLS;
  s.tri = s.pln + n_pln * PLN_COLS;
  s.mat = s.tri + n_tri * TRI_COLS;
  s.n_sph = n_sph;
  s.n_pln = n_pln;
  s.n_tri = n_tri;
  s.n_mat = n_mat;
  return s;
}

// -- trace_attrs (pallas_intersect.trace_attrs_body), one lane ---------------

// The closest hit and its attributes (intersect._hit_attributes).
struct HitAttrs {
  float t;
  int type, idx;  // the sweep's winner: (3e38, -1, 0) on a miss
  bool did_hit;
  float px, py, pz;
  V3 normal;
  int mat_id;        // the winner's material id, as the scene stores it
  const float* mat;  // its material row (MAT_COLS layout)
};

// Closest sweep, the hit point (the ray origin on a miss: t_safe = 0),
// the winner's normal and material. A lane whose winner is another type,
// or a miss, reads row 0 of a table like the reference's selects; a miss
// takes the triangle branch (pallas_intersect.small_winner_normals /
// winner_rows). CLOSEST writes it out; trace_attrs goes on from it.
__device__ __forceinline__ HitAttrs closest_attrs(const SceneView& s, const Ray& r) {
  HitAttrs a;
  sweep(s, r, false, a.t, a.type, a.idx);
  a.did_hit = a.type >= 0;
  const float t_safe = a.did_hit ? a.t : 0.0f;
  a.px = r.ox + r.dx * t_safe;
  a.py = r.oy + r.dy * t_safe;
  a.pz = r.oz + r.dz * t_safe;

  float mat_f;
  if (a.type == 0) {
    const float* sp = s.sph + a.idx * SPH_COLS;
    a.normal = sphere_normal(sp[0], sp[1], sp[2], sp[4], r, a.px, a.py, a.pz);
    mat_f = sp[5];
  } else if (a.type == 1) {
    const float* pp = s.pln + a.idx * PLN_COLS;
    a.normal = plane_normal(pp[0], pp[1], pp[2], r);
    mat_f = pp[12];
  } else {
    const float* tp = s.tri + (a.type == 2 ? a.idx : 0) * TRI_COLS;
    a.normal = tri_normal(V3{tp[20], tp[21], tp[22]}, V3{tp[3], tp[4], tp[5]}, V3{tp[6], tp[7], tp[8]},
                          V3{tp[23], tp[24], tp[25]}, V3{tp[26], tp[27], tp[28]},
                          V3{tp[29], tp[30], tp[31]}, r);
    mat_f = tp[32];
  }
  a.mat_id = (int)mat_f;
  a.mat = material_row(s.mat, s.n_mat, a.mat_id);
  return a;
}

struct TraceAttrs : HitAttrs {
  bool occ;
};

// closest_attrs, then the NEE shadow sweep from the hit point along `nee`.
__device__ __forceinline__ TraceAttrs trace_attrs(const SceneView& s, const Ray& r, V3 nee) {
  TraceAttrs a;
  static_cast<HitAttrs&>(a) = closest_attrs(s, r);
  float occ_t;
  int occ_type, occ_idx;
  sweep(s, Ray{a.px, a.py, a.pz, nee.x, nee.y, nee.z}, true, occ_t, occ_type, occ_idx);
  a.occ = occ_t < INF;
  return a;
}

// -- trace_epilogue (pallas_wavefront.trace_epilogue) ------------------------

struct Epilogue {
  float cos_theta;
  V3 nee_scatter;
  float nee_pdf;
  BsdfSample bs;
  float cos_bounce;
};

// Material parameters, the NEE BSDF eval/pdf and the bounce sample (two
// RNG draws on `state`).
__device__ __forceinline__ Epilogue trace_epilogue(V3 rd, V3 nee, V3 normal, V3 color,
                                                   float rough, float metal, uint32_t& state) {
  const float alpha = maxn(rough * rough, (float)0.001);
  const float msat = sat(metal);
  const V3 f0{DIELECTRIC_F0 + (color.x - DIELECTRIC_F0) * msat,
              DIELECTRIC_F0 + (color.y - DIELECTRIC_F0) * msat,
              DIELECTRIC_F0 + (color.z - DIELECTRIC_F0) * msat};
  Epilogue e;
  e.cos_theta = maxn(vdot(normal, nee), 0.0f);
  const Frame frame = make_frame(normal);
  const V3 wo = to_local(frame, V3{-rd.x, -rd.y, -rd.z});
  const V3 wi = to_local(frame, nee);
  e.nee_scatter = bsdf_eval(wo, wi, color, metal, alpha, f0);
  e.nee_pdf = bsdf_pdf(wo, wi, f0, alpha);
  e.bs = bsdf_sample(state, rd, normal, color, metal, alpha, f0);
  e.cos_bounce = maxn(vdot(normal, e.bs.dir), 0.0f);
  return e;
}

// -- SHADE core (pallas_wavefront._shade_core), one lane ---------------------

// The 22 outputs (SHADE_OUT_NAMES).
struct ShadeOut {
  uint32_t* state;
  float *ro0, *ro1, *ro2, *rd0, *rd1, *rd2;
  float *tp0, *tp1, *tp2, *inc0, *inc1, *inc2, *last_pdf;
  int32_t* bounce;
  uint32_t* sample;
  int32_t* in_path;
  float *film0, *film1, *film2;
  int32_t *active, *hitmask;
};

struct ShadeScalars {
  int n, env_w, env_h, width, height, max_bounces;
  uint32_t it_next, spp, budget, stride, offset;
};

// RGBE bilinear radiance from the quad row, the texel pmf, MIS, emission,
// film, termination and regeneration; writes lane i of `o`. `in` reads
// lane i's inputs where they are used (so a kernel that loads them from
// device memory keeps few registers live): the trace products hit() occ()
// px() py() pz() er() eg() eb() ct() ns(c) npdf() bd(c) bpdf() bs(c) bz()
// cb() state() fu() fv() npmf(), the carry tp(c) inc(c) last_pdf()
// bounce() sample() in_path() film(c) ro(c) rd(c), the pixel pixidx()
// pixx() pixy() base() and the quad row quad(). `scal`: [max_y, aspect,
// cam pos[3], cam rot rows[9], L, Z].
template <class In>
__device__ __forceinline__ void shade_core(int i, const In& in, const float* scal,
                                           const ShadeScalars& k, const ShadeOut& o) {
  const int W = k.env_w, H = k.env_h;
  const bool active = in.in_path();
  const bool did_hit = in.hit();
  const bool is_hit = active && did_hit;
  const bool is_miss = active && !did_hit;
  const V3 throughput{in.tp(0), in.tp(1), in.tp(2)};
  V3 incoming{in.inc(0), in.inc(1), in.inc(2)};
  const float fu = in.fu(), fv = in.fv();

  // quad row -> bilinear radiance + texel pmf (envmap.py RGBE path)
  const float x = fu * (float)W - 0.5f;
  const float y = fv * (float)H - 0.5f;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x0 < 0.0f ? 0.0f : x - x0;
  const float fy = y0 < 0.0f ? 0.0f : y - y0;
  const int x0i = clampi(__float2int_rz(x0), 0, W - 1);
  const int y0i = clampi(__float2int_rz(y0), 0, H - 1);
  const uint4 q = in.quad();
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
  const float pmf = is_hit ? in.npmf() : quad_pmf;
  const float solid = (float)((2.0 * PI_D / W) * (PI_D / H)) * maxn(sinf(PI_F * fv), (float)1.0e-6);
  const float pdf_env = pmf / solid;

  // miss: environment light with MIS
  const float lp = in.last_pdf();
  const float a2 = lp * lp, b2 = pdf_env * pdf_env;
  const float miss_weight = a2 / maxn(a2 + b2, (float)1.0e-30);
  incoming.x = incoming.x + (is_miss ? throughput.x * radiance.x * miss_weight : 0.0f);
  incoming.y = incoming.y + (is_miss ? throughput.y * radiance.y * miss_weight : 0.0f);
  incoming.z = incoming.z + (is_miss ? throughput.z * radiance.z * miss_weight : 0.0f);

  // hit: emission + NEE
  incoming.x = incoming.x + (is_hit ? throughput.x * in.er() : 0.0f);
  incoming.y = incoming.y + (is_hit ? throughput.y * in.eg() : 0.0f);
  incoming.z = incoming.z + (is_hit ? throughput.z * in.eb() : 0.0f);
  const float cos_theta = in.ct();
  const float npdf = in.npdf();
  const float e2 = pdf_env * pdf_env, n2 = npdf * npdf;
  const float nee_weight = e2 / maxn(e2 + n2, (float)1.0e-30);
  const bool nee_ok = is_hit && (cos_theta > 0.0f) && (pdf_env > 0.0f) && !in.occ();
  const float cos_over_pdf = cos_theta / maxn(pdf_env, (float)1.0e-30);
  incoming.x = incoming.x + (nee_ok ? throughput.x * nee_weight * radiance.x * in.ns(0) * cos_over_pdf : 0.0f);
  incoming.y = incoming.y + (nee_ok ? throughput.y * nee_weight * radiance.y * in.ns(1) * cos_over_pdf : 0.0f);
  incoming.z = incoming.z + (nee_ok ? throughput.z * nee_weight * radiance.z * in.ns(2) * cos_over_pdf : 0.0f);

  // bounce / termination
  const bool bzero = in.bz();
  const V3 bscat{in.bs(0), in.bs(1), in.bs(2)};
  if (is_hit && bzero) incoming = bscat;
  const float bpdf = in.bpdf();
  const float tp_scale = in.cb() / maxn(bpdf, (float)1.0e-30);
  const V3 new_tp{throughput.x * bscat.x * tp_scale, throughput.y * bscat.y * tp_scale,
                  throughput.z * bscat.z * tp_scale};
  const float tp_norm = sqrtf(new_tp.x * new_tp.x + new_tp.y * new_tp.y + new_tp.z * new_tp.z);
  int bounce = in.bounce() + 1;
  const bool continues = is_hit && !bzero && (bpdf > 0.0f) && (tp_norm >= THROUGHPUT_CUTOFF) &&
                         (bounce < k.max_bounces);
  const bool path_done = active && !continues;
  const float film0 = in.film(0) + (path_done ? incoming.x : 0.0f);
  const float film1 = in.film(1) + (path_done ? incoming.y : 0.0f);
  const float film2 = in.film(2) + (path_done ? incoming.z : 0.0f);
  const uint32_t sample = in.sample();
  const uint32_t next_sample = path_done ? sample + 1u : sample;

  // regenerate: reseed from (pixel, global sample); unsigned compares,
  // so 0xFFFFFFFF means "no limit".
  const bool regen = path_done && (next_sample < k.spp) && (k.it_next < k.budget);
  const uint32_t global_sample = (in.base() + next_sample) * k.stride + k.offset;
  uint32_t fstate = 0u ^ in.pixidx();
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
  const float jpx = (float)in.pixx() + jx;
  const float jpy = (float)in.pixy() + jy;
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
  o.state[i] = regen ? fstate : in.state();
  o.ro0[i] = regen ? scal[2] + 0.0f : (continues ? in.px() : in.ro(0));
  o.ro1[i] = regen ? scal[3] + 0.0f : (continues ? in.py() : in.ro(1));
  o.ro2[i] = regen ? scal[4] + 0.0f : (continues ? in.pz() : in.ro(2));
  o.rd0[i] = regen ? fd0 : (continues ? in.bd(0) : in.rd(0));
  o.rd1[i] = regen ? fd1 : (continues ? in.bd(1) : in.rd(1));
  o.rd2[i] = regen ? fd2 : (continues ? in.bd(2) : in.rd(2));
  o.tp0[i] = regen ? 1.0f : (continues ? new_tp.x : throughput.x);
  o.tp1[i] = regen ? 1.0f : (continues ? new_tp.y : throughput.y);
  o.tp2[i] = regen ? 1.0f : (continues ? new_tp.z : throughput.z);
  const bool clear = regen || path_done;
  o.inc0[i] = clear ? 0.0f : incoming.x;
  o.inc1[i] = clear ? 0.0f : incoming.y;
  o.inc2[i] = clear ? 0.0f : incoming.z;
  o.last_pdf[i] = regen ? 1.0f : (continues ? bpdf : lp);
  o.bounce[i] = regen ? 0 : bounce;
  o.sample[i] = next_sample;
  o.in_path[i] = in_path ? 1 : 0;
  o.film0[i] = film0;
  o.film1[i] = film1;
  o.film2[i] = film2;
  o.active[i] = active ? 1 : 0;
  o.hitmask[i] = is_hit ? 1 : 0;
}

}  // namespace rt
