// Device functions shared by the TRACE and SHADE kernels (wavefront.cu).
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

// Packed scene table rows (ops/cuda_wavefront.py:scene_table).
constexpr int SPH_COLS = 8;   // pos[3] c2 radius material valid -
constexpr int PLN_COLS = 16;  // n[3] ndotp r0[3] r2[3] r0dotp r2dotp material valid - -
constexpr int TRI_COLS = 36;  // cdet[3] e0[3] e1[3] cu[3] cv[3] n[3] adotn valid a[3] n0[3] n1[3] n2[3] material - - -
constexpr int MAT_COLS = 8;   // color[3] roughness metallic emission[3]

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

}  // namespace rt
